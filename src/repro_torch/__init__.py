"""PyTorch / CUDA port of the V2X FL system for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core``, ``fl``, ``kernels``, ...) and imports nothing of it.
"""
