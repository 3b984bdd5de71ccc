"""Pairwise cosine similarity (the stage-3 Gram): CUDA kernel and its plain version.

Port of ``repro/kernels/pairwise_cosine.py`` (Pallas ``_matmul_nt_kernel``
behind ``gram_nt`` and ``pairwise_cosine``).  ``gram_nt(x, y)`` is the NT
product ``x @ y.T`` in fp32; ``pairwise_cosine(x)`` row-normalizes ``x`` in
plain torch, as the JAX wrapper does outside its ``pallas_call``, and takes
the Gram of the normalized rows.  CUDA tensors launch
``csrc/pairwise_cosine.cu``; CPU tensors run ``gram_nt_plain``.  There is
no fallback from one to the other.  The Gram of ``x`` with itself runs the
kernel's symmetric form, which computes the tiles on and above the diagonal
and mirrors them, so it is bitwise symmetric on the card; a zero row gives
an exactly zero row and column.  ``plan`` sizes the launch: the tile, and
at small N a split of D across blocks, summed in a fixed order by the last
block of each tile in the same launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad

# Kernel launches made by ``gram_nt`` (one per call on CUDA tensors).
launches = 0

# The H100's SM count: ``plan`` sizes the grid to cover it (any card runs
# any plan; this only sets how many blocks a call makes).
SMS = 132
TILE_K = 32  # the kernel's k slab


def plan(n: int, m: int, d: int, symmetric: bool):
    """The kernel's launch for an ``(n, d) x (m, d)^T`` product ->
    ``(tm, splits, tiles)``: tiles of ``16 tm`` rows and columns, 128 when
    that gives at least one tile per SM (only the upper triangle's when
    ``symmetric``), else 32; with fewer tiles than SMs at 32, D is split
    ``splits`` ways (two blocks per SM, at least two k slabs each)."""
    for tm in (8, 2):
        bm = 16 * tm
        rt, ct = -(-n // bm), -(-m // bm)
        tiles = rt * (rt + 1) // 2 if symmetric else rt * ct
        if tiles >= SMS:
            return tm, 1, tiles
    k_slabs = -(-d // TILE_K)
    return 2, max(1, min(2 * SMS // max(tiles, 1), k_slabs // 2)), tiles


def gram_nt_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (N, D) @ y (M, D)^T -> (N, M)`` in fp32."""
    return x.float() @ y.float().T


def _normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    return xf / torch.clamp_min(torch.linalg.vector_norm(xf, dim=1, keepdim=True), 1e-12)


def pairwise_cosine_plain(x: torch.Tensor) -> torch.Tensor:
    """``(N, D) -> (N, N)`` cosine similarity, fp32 (``ref.pairwise_cosine``)."""
    xn = _normalize(x)
    return gram_nt_plain(xn, xn)


def _gram_nt_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    from repro_torch.kernels.build import check, counters, library

    refuse_grad("pairwise_cosine", x, y)
    global launches
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"gram_nt: need x (N, D) and y (M, D), got {tuple(x.shape)} "
                         f"and {tuple(y.shape)}")
    if y.device != x.device:
        raise ValueError(f"gram_nt: x on {x.device} but y on {y.device}")
    symmetric = y is x
    # the kernel reads fp32 rows: a bf16 row widens exactly
    x = x.to(torch.float32).contiguous()
    y = x if symmetric else y.to(torch.float32).contiguous()
    N, D = x.shape
    M = y.shape[0]
    tm, splits, tiles = plan(N, M, D, symmetric)
    out = torch.empty((N, M), dtype=torch.float32, device=x.device)
    scratch = arrivals = None
    if splits > 1:
        scratch = torch.empty((tiles * splits * (16 * tm) ** 2,), dtype=torch.float32,
                              device=x.device)
        arrivals = counters(x.device, "gram_nt", tiles)
    aligned = D % 4 == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = library().gram_nt_launch(
        x.data_ptr(), y.data_ptr(), N, M, D, int(symmetric), tm, splits, 4 if aligned else 1,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        None if arrivals is None else arrivals.data_ptr(), stream)
    check(status, "gram_nt")
    launches += 1
    return out


def gram_nt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (N, D) @ y (M, D)^T -> (N, M)`` fp32: the kernel on the card
    (its symmetric form when ``y is x``)."""
    if x.is_cuda:
        return _gram_nt_cuda(x, y)
    if x.device.type != "cpu":
        raise ValueError(f"gram_nt: unsupported device {x.device}")
    return gram_nt_plain(x, y)


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """``(N, D) -> (N, N)`` cosine similarity, fp32: rows normalized (norm
    clamped at 1e-12), then their Gram through ``gram_nt``."""
    xn = _normalize(x)
    return gram_nt(xn, xn)
