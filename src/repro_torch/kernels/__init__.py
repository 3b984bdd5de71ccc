"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

One module per kernel source (``rttg_latency``, ``fedavg_reduce``,
``server_update``, ``rsu_reduce``, ``swa_decode``, ``ssd_scan``).  Each wrapper
dispatches on its tensors' device: CUDA tensors launch the CUDA kernel
(built on first use by ``kernels.build``), CPU tensors run the plain
version.  Each module keeps a plain integer ``launches`` counter.
"""
__all__ = ("rttg_latency", "fedavg_reduce", "server_update", "rsu_reduce", "swa_decode",
           "ssd_scan")
