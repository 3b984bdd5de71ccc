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
version is ``fedavg_reduce_grid_plain``.  Both launch the one kernel, at
the launch plan ``column_plan`` gives (which ``server_update``'s kernel
shares): the load width and the runs a thread.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import count_launch, indexed, on_card, refuse_grad

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


# ---- the column streamers' launch plan (B2, B2g, B3, B4, B3g, B4g) ---------------------

THREADS = 128  # threads a block of csrc/fedavg_reduce.cu and csrc/server_update.cu
RUN_BYTES = 16  # bytes a thread of a wide plan loads from each row
# A wide plan must leave every SM at least this many blocks (column tiles)
# of its lanes; below, one run a thread spreads the columns over more blocks.
# On an H100 (chip_smoke.py's column_plan_sweep) one run a thread was faster
# for both kernels at one lane of 159,010 columns, where the wide plan gives
# an SM 2.4 blocks (fp32 rows) or 1.2 (bf16 rows); the wide plan was faster
# at one lane of 1,070,794 bf16 columns (7.9 blocks an SM) and at every
# grid.  At one lane of 1,070,794 fp32 columns (15.8) one run was ~3%
# faster, which this threshold does not catch.
FILL_PER_SM = 4


class ColumnPlan(NamedTuple):
    """A launch of a column streamer: a thread loads ``vec`` elements of a
    row at once (``vec * item`` bytes) for each of its ``runs`` runs of a
    column tile of ``THREADS * runs * vec`` columns; a block a tile, ``tiles``
    tiles a lane."""
    vec: int
    runs: int
    tiles: int


def wide_runs(vec: int, item: int) -> int:
    """The runs a thread of a wide plan: ``RUN_BYTES`` bytes a row (at least
    one run)."""
    return max(1, RUN_BYTES // (vec * item))


def column_tiles(P: int, vec: int, runs: int) -> int:
    return -(-P // (THREADS * vec * runs))


def column_plan(lanes: int, P: int, vec: int, item: int, sms: int) -> ColumnPlan:
    """The launch plan of ``lanes`` lanes of P columns whose rows hold
    ``item``-byte elements, loaded ``vec`` at a time, on a card of ``sms``
    SMs: the wide runs (``RUN_BYTES`` bytes a thread a row) where the lanes'
    tiles at that width give every SM ``FILL_PER_SM`` blocks, else one run a
    thread."""
    wide = wide_runs(vec, item)
    runs = wide if lanes * column_tiles(P, vec, wide) >= FILL_PER_SM * sms else 1
    return ColumnPlan(vec, runs, column_tiles(P, vec, runs))


_SMS = {}  # indexed device -> SMs


def sm_count(device) -> int:
    device = indexed(device)
    hit = _SMS.get(device)
    if hit is None:
        hit = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return hit


def launch_plan(device, lanes: int, P: int, rows: torch.Tensor,
                out: torch.Tensor) -> ColumnPlan:
    """``column_plan`` of ``fedavg_reduce``'s kernel for these rows and out."""
    vec = min(_vector_width(rows, P), _vector_width(out, P))
    return column_plan(lanes, P, vec, rows.element_size(), sm_count(device))


def _launch(name: str, updates: torch.Tensor, weights: torch.Tensor, lanes: int, K: int,
            P: int, out: torch.Tensor) -> None:
    from repro_torch.kernels.build import check, library

    plan = launch_plan(updates.device, lanes, P, updates, out)
    with on_card(updates):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        check(library().fedavg_reduce_launch(updates.data_ptr(), updates.element_size(),
                                             weights.data_ptr(), lanes, K, P, plan.vec,
                                             plan.runs, out.data_ptr(), stream), name)


def _fedavg_reduce_cuda(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    refuse_grad("fedavg_reduce", updates, weights)
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
    _launch("fedavg_reduce", updates, weights, 1, K, P, out)
    count_launch(__name__)
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
    refuse_grad("fedavg_reduce_grid", updates, weights)
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
    _launch("fedavg_reduce_grid", updates, weights, G, K, P, out)
    count_launch(__name__, "grid_launches")
    return out


def fedavg_reduce_grid(updates: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Each lane's weighted sum over its cohort axis -> (G, P) fp32."""
    if updates.is_cuda:
        return _fedavg_reduce_grid_cuda(updates, weights)
    if updates.device.type != "cpu":
        raise ValueError(f"fedavg_reduce_grid: unsupported device {updates.device}")
    return fedavg_reduce_grid_plain(updates, weights)
