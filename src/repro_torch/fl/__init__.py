"""The FL runtime: partitioning, clients, server, the round core, the simulation."""
