"""FedAvg weighted cohort sum: CUDA kernel and its plain version.

Port of ``repro/kernels/fedavg_reduce.py`` (Pallas ``_reduce_kernel``):
``(K, P) x (K,) -> (P,)`` fp32, ``out[p] = sum_k w[k] u[k, p]``, the update
rows in fp32 or bf16 (the bf16 lane's rows; they widen to fp32 exactly and
the sum accumulates in fp32).  CUDA tensors launch ``csrc/fedavg_reduce.cu``;
CPU tensors run ``fedavg_reduce_plain``.  There is no fallback from one to
the other.

``fedavg_reduce_grid`` is the batched grid round's form (B2g, the
reference kernel under the engine's ``vmap``): ``(G, K, P) x (G, K) -> (G,
P)`` in one launch, bitwise ``fedavg_reduce`` on each lane; its plain
version is ``fedavg_reduce_grid_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad

# Kernel launches made by ``fedavg_reduce`` (one per call on CUDA tensors).
launches = 0
# Kernel launches made by ``fedavg_reduce_grid`` (one per call on CUDA tensors).
grid_launches = 0
MAX_LANES = 65535  # the kernel's lanes are its grid's second dimension

# Row dtypes the CUDA kernels read in their own bodies (2- and 4-byte rows).
ROW_DTYPES = (torch.float32, torch.bfloat16)


def fedavg_reduce_plain(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The weighted sum over the cohort axis in fp32."""
    return torch.einsum("k,kp->p", weights.to(torch.float32), updates.to(torch.float32))


def _vector_width(x: torch.Tensor, P: int) -> int:
    """The widest of 4, 2 and 1 elements that divides P and aligns ``x``'s
    rows to that many of its own elements."""
    for vec in (4, 2):
        if P % vec == 0 and x.data_ptr() % (x.element_size() * vec) == 0:
            return vec
    return 1


def _fedavg_reduce_cuda(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.build import check, library

    refuse_grad("fedavg_reduce", updates, weights)
    global launches
    if updates.dtype not in ROW_DTYPES or updates.dim() != 2 or not updates.is_contiguous():
        raise ValueError(f"fedavg_reduce: updates must be a contiguous (K, P) float32 or "
                         f"bfloat16 tensor, got {updates.dtype} {tuple(updates.shape)}")
    K, P = updates.shape
    if (weights.device != updates.device or weights.dtype != torch.float32
            or weights.shape != (K,) or not weights.is_contiguous()):
        raise ValueError(f"fedavg_reduce: weights must be a contiguous ({K},) "
                         f"float32 tensor on {updates.device}")
    if K < 1:
        raise ValueError("fedavg_reduce: the cohort must have at least one row")
    out = torch.empty((P,), dtype=torch.float32, device=updates.device)
    vec = min(_vector_width(updates, P), _vector_width(out, P))
    stream = torch.cuda.current_stream(updates.device).cuda_stream
    status = library().fedavg_reduce_launch(
        updates.data_ptr(), updates.element_size(), weights.data_ptr(), K, P, vec,
        out.data_ptr(), stream,
    )
    check(status, "fedavg_reduce")
    launches += 1
    return out


def fedavg_reduce(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum over the cohort axis -> (P,) fp32."""
    if updates.is_cuda:
        return _fedavg_reduce_cuda(updates, weights)
    if updates.device.type != "cpu":
        raise ValueError(f"fedavg_reduce: unsupported device {updates.device}")
    return fedavg_reduce_plain(updates, weights)


def fedavg_reduce_grid_plain(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each lane's weighted sum over its cohort axis in fp32: lane g is
    ``fedavg_reduce_plain`` of lane g.

    One ``einsum("gk,gkp->gp")`` computes the same sums, but its batched
    product rounds a few leading columns differently from the one-lane
    product at a cohort of 12 and more (measured on the CPU), so it would
    not reproduce the lane loop: the lanes go one call each.
    """
    return torch.stack([fedavg_reduce_plain(u, w) for u, w in zip(updates, weights)])


def _fedavg_reduce_grid_cuda(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.build import check, library

    refuse_grad("fedavg_reduce_grid", updates, weights)
    global grid_launches
    if updates.dtype not in ROW_DTYPES or updates.dim() != 3 or not updates.is_contiguous():
        raise ValueError(f"fedavg_reduce_grid: updates must be a contiguous (G, K, P) float32 "
                         f"or bfloat16 tensor, got {updates.dtype} {tuple(updates.shape)}")
    G, K, P = updates.shape
    if (weights.device != updates.device or weights.dtype != torch.float32
            or weights.shape != (G, K) or not weights.is_contiguous()):
        raise ValueError(f"fedavg_reduce_grid: weights must be a contiguous ({G}, {K}) "
                         f"float32 tensor on {updates.device}")
    if K < 1 or not 1 <= G <= MAX_LANES:
        raise ValueError(f"fedavg_reduce_grid: need K >= 1 and 1 <= G <= {MAX_LANES}, "
                         f"got G={G}, K={K}")
    out = torch.empty((G, P), dtype=torch.float32, device=updates.device)
    vec = min(_vector_width(updates, P), _vector_width(out, P))
    stream = torch.cuda.current_stream(updates.device).cuda_stream
    status = library().fedavg_reduce_grid_launch(
        updates.data_ptr(), updates.element_size(), weights.data_ptr(), G, K, P, vec,
        out.data_ptr(), stream,
    )
    check(status, "fedavg_reduce_grid")
    grid_launches += 1
    return out


def fedavg_reduce_grid(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each lane's weighted sum over its cohort axis -> (G, P) fp32."""
    if updates.is_cuda:
        return _fedavg_reduce_grid_cuda(updates, weights)
    if updates.device.type != "cpu":
        raise ValueError(f"fedavg_reduce_grid: unsupported device {updates.device}")
    return fedavg_reduce_grid_plain(updates, weights)
