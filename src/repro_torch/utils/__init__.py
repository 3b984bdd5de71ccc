"""Helpers: the JAX-compatible PRNG, the flat parameter layout, devices."""
