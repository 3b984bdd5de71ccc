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

The wrappers launch on any card, from any host thread: each makes its
operand's card current around the C entry call (``on_card``: a CUDA launch
goes to the calling thread's current device, whatever card its operands
are on), keys its per-device caches on indexed devices (``indexed``:
``cuda`` is ``cuda:<current>``), and counts its launches under a lock
(``count_launch``), so that host threads launching at once lose no count.
A worker process counts its own launches; its caller adds them to its
counters (``launch_counts``, ``add_launches``: the engine's process lane).
"""
import sys
import threading

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


def on_card(x: torch.Tensor) -> torch.cuda.device:
    """A context that makes ``x``'s card the calling thread's current device,
    around a C entry call: the launch goes to the current device, the stream
    the wrapper passes is ``x``'s card's."""
    return torch.cuda.device(x.device)


def indexed(device) -> torch.device:
    """``device`` with its card's index (``cuda`` -> ``cuda:<current>``), so
    that a per-device cache holds one entry a card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


_COUNT_LOCK = threading.Lock()


def count_launch(module: str, counter: str = "launches") -> None:
    """Add one to ``module``'s launch counter ``counter``.  Under a lock:
    ``+= 1`` on a module global is not atomic across host threads."""
    mod = sys.modules[module]
    with _COUNT_LOCK:
        setattr(mod, counter, getattr(mod, counter) + 1)


# every launch counter: (kernel module, counter)
COUNTERS = (("rttg_latency", "launches"), ("rttg_latency", "grid_launches"),
            ("fedavg_reduce", "launches"), ("fedavg_reduce", "grid_launches"),
            ("server_update", "launches"), ("server_update", "buffered_launches"),
            ("server_update", "grid_launches"), ("server_update", "buffered_grid_launches"),
            ("rsu_reduce", "launches"), ("rsu_reduce", "grid_launches"),
            ("swa_decode", "launches"), ("ssd_scan", "launches"),
            ("pairwise_cosine", "launches"))


def launch_counts() -> dict:
    """Every launch counter of this process, ``{(module, counter): count}``."""
    import importlib

    return {(m, c): getattr(importlib.import_module(f"{__name__}.{m}"), c) for m, c in COUNTERS}


def add_launches(deltas: dict) -> None:
    """Add ``{(module, counter): n}`` (another process's launches, say) to
    this process's counters, under ``count_launch``'s lock."""
    import importlib

    mods = {m: importlib.import_module(f"{__name__}.{m}") for m, _ in deltas}
    with _COUNT_LOCK:
        for (m, c), n in deltas.items():
            setattr(mods[m], c, getattr(mods[m], c) + n)
