"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

One module per kernel source (``rttg_latency``, ``fedavg_reduce``,
``server_update``, ``rsu_reduce``, ``swa_decode``, ``ssd_scan``,
``pairwise_cosine``).  Each wrapper
dispatches on its tensors' device: CUDA tensors launch the CUDA kernel
(built on first use by ``kernels.build``), CPU tensors run the plain
version.  Each module keeps a plain integer ``launches`` counter.

No kernel has a backward.  On the card every wrapper refuses an operand
that requires grad while grad mode is on (``refuse_grad``): the kernel
writes fresh tensors through ``ctypes``, so autograd would give every input
upstream of it no gradient, silently.  The plain versions are
differentiable torch on any device; the one training path that meets a
kernel's function, the ``ssm`` / ``hybrid`` families' scan, calls
``ssd_scan.ssd_scan_plain`` itself under grad mode (``models/ssm.py``), as
the reference's models train through its plain scan.
"""
import torch

__all__ = ("rttg_latency", "fedavg_reduce", "server_update", "rsu_reduce", "swa_decode",
           "ssd_scan", "pairwise_cosine")


def refuse_grad(name: str, *operands, use: str = "") -> None:
    """Raise where grad mode is on and an operand (a tensor, or None) requires
    grad: kernel ``name`` has no backward; ``use`` names the differentiable
    path, where there is one."""
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in operands):
        todo = f"; to train, {use}" if use else ""
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an operand requires grad with "
            f"grad mode on; run it under torch.no_grad() or detach the operands{todo}")
