"""Segment reduce by RSU attachment: CUDA kernel and its plain version.

Port of ``repro/kernels/rsu_reduce.py`` (Pallas ``_seg_kernel``), the edge
half of two-tier FedAvg: ``(K, P)`` updates, ``(K,)`` weights and ``(K,)``
attachment ids -> ``(R, P)`` per-RSU partials and ``(R,)`` masses,

    partials[r] = sum_k [rid_k == r] w_k u_k,   mass[r] = sum_k [rid_k == r] w_k.

An id outside ``[0, R)`` contributes nothing.  The rows come in fp32 or
bf16 and the sum accumulates in fp32; ``out_dtype`` (fp32 or bf16, fp32 by
default) is the partials' dtype, as the reference's ``out_dtype`` (the bf16
lane's chunk carry).  An optional ``carry`` is the chunk walk's running
``(R, P)`` partials, in ``out_dtype``: the sum is added to it in place as the
JAX round's ``partials + part_c`` rounds it, the sum first rounded to
``out_dtype`` (``part_c``), then added in fp32 and rounded again (one
rounding in fp32, where the first is exact).  CUDA tensors launch
``csrc/rsu_reduce.cu``; CPU tensors run ``rsu_reduce_plain``.  There is no
fallback from one to the other.

``rsu_reduce_grid`` is the batched grid round's form (B5g, the reference
kernel under the engine's ``vmap``): ``(G, K, P)`` rows, ``(G, K)`` weights
and ids and an optional ``(G, R, P)`` carry -> ``(G, R, P)`` partials and
``(G, R)`` masses in one launch, bitwise ``rsu_reduce`` on each lane; its
plain version is ``rsu_reduce_grid_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch, on_card, refuse_grad
from repro_torch.kernels.fedavg_reduce import _vector_width

# Kernel launches made by ``rsu_reduce`` (one per call on CUDA tensors).
launches = 0
# Kernel launches made by ``rsu_reduce_grid`` (one per call on CUDA tensors).
grid_launches = 0
# The kernel's lanes are its grid's third dimension.
MAX_LANES = 65535

# The kernel's blocks take groups of 32 RSUs along the grid's y axis, whose
# extent (65,535) bounds R.
MAX_RSU = 32 * 65535

# (rows, partials) dtypes the kernel takes: bf16 partials only from bf16
# rows, the pairing the bf16 lane makes (the plain version takes any).
TYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16))


def vector_width(p_cols: int, *tensors: torch.Tensor) -> int:
    """The kernel's vector width: the widest of 4, 2 and 1 elements that
    divides P and aligns every tensor's rows (each in its own element size)."""
    return min(_vector_width(x, p_cols) for x in tensors)


def rsu_reduce_plain(updates: torch.Tensor, weights: torch.Tensor, rid: torch.Tensor,
                     n_rsu: int, carry=None, out_dtype=torch.float32):
    """The reference's one-hot ``(K, R)`` routing matrix ``m``: ``m.t() @ u``
    in fp32, rounded to ``out_dtype``, and ``m.sum(0)``; with a carry,
    ``carry += that``."""
    w = weights.to(torch.float32)
    onehot = rid.to(torch.int64)[:, None] == torch.arange(n_rsu, device=rid.device)[None, :]
    m = onehot.to(torch.float32) * w[:, None]
    partials = (m.t() @ updates.to(torch.float32)).to(out_dtype)
    mass = m.sum(dim=0)
    if carry is not None:
        partials = carry.add_(partials)
    return partials, mass


def _check(name, x, shape, dtype, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"rsu_reduce: {name} must be a contiguous {shape} {dtype} tensor "
                         f"on {device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _operands_cuda(name, updates, weights, rid, n_rsu, carry, out_dtype, lanes):
    """Check the kernel's operands (``lanes`` leading lane axes: 0 for B5, 1
    for B5g) -> (partials to write, masses to write, vector width)."""
    lead = updates.shape[:lanes]
    if updates.dim() != 2 + lanes or not updates.is_contiguous():
        form = "(G, K, P)" if lanes else "(K, P)"
        raise ValueError(f"{name}: updates must be a contiguous {form} tensor, "
                         f"got {tuple(updates.shape)}")
    if (updates.dtype, out_dtype) not in TYPE_PAIRS:
        raise ValueError(f"{name}: the kernel takes (rows, partials) in {TYPE_PAIRS}, "
                         f"got ({updates.dtype}, {out_dtype})")
    if not 1 <= n_rsu <= MAX_RSU:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_RSU} RSUs, got {n_rsu}")
    K, P = updates.shape[lanes:]
    if K < 1:
        raise ValueError(f"{name}: the cohort chunk must have at least one row")
    if lanes and not 1 <= lead[0] <= MAX_LANES:
        raise ValueError(f"{name}: the kernel takes 1 to {MAX_LANES} lanes, got {lead[0]}")
    device = updates.device
    _check("weights", weights, lead + (K,), torch.float32, device)
    _check("rid", rid, lead + (K,), torch.int32, device)
    if carry is None:
        out = torch.empty(lead + (n_rsu, P), dtype=out_dtype, device=device)
    else:
        _check("carry", carry, lead + (n_rsu, P), out_dtype, device)
        out = carry
    mass = torch.empty(lead + (n_rsu,), dtype=torch.float32, device=device)
    return out, mass, vector_width(P, updates, out)


def _launch(name, updates, weights, rid, n_rsu, carry, out_dtype, lanes):
    """One launch of the kernel's C entry (``lanes`` leading lane axes: 0
    for B5, one lane; 1 for B5g, G lanes) -> (partials, masses)."""
    from repro_torch.kernels.build import check, library

    refuse_grad(name, updates, weights, carry)
    out, mass, vec = _operands_cuda(name, updates, weights, rid, n_rsu, carry, out_dtype,
                                    lanes)
    G = updates.shape[0] if lanes else 1
    K, P = updates.shape[lanes:]
    with on_card(updates):
        stream = torch.cuda.current_stream(updates.device).cuda_stream
        status = library().rsu_reduce_launch(
            updates.data_ptr(), updates.element_size(), weights.data_ptr(), rid.data_ptr(), G,
            K, n_rsu, P, vec, None if carry is None else carry.data_ptr(), out.data_ptr(),
            out.element_size(), mass.data_ptr(), stream,
        )
    check(status, name)
    return out, mass


def rsu_reduce(updates: torch.Tensor, weights: torch.Tensor, rid: torch.Tensor,
               n_rsu: int, carry=None, out_dtype=torch.float32):
    """Segment reduce -> (partials (R, P) in ``out_dtype``, mass (R,) fp32).

    ``rid`` is int32 on the card.  With ``carry`` (R, P, in ``out_dtype``)
    the partials are ``carry`` itself, updated in place.
    """
    if updates.is_cuda:
        out = _launch("rsu_reduce", updates, weights, rid, n_rsu, carry, out_dtype, 0)
        count_launch(__name__)
        return out
    if updates.device.type != "cpu":
        raise ValueError(f"rsu_reduce: unsupported device {updates.device}")
    return rsu_reduce_plain(updates, weights, rid, n_rsu, carry, out_dtype)


def rsu_reduce_grid_plain(updates: torch.Tensor, weights: torch.Tensor, rid: torch.Tensor,
                          n_rsu: int, carry=None, out_dtype=torch.float32):
    """Each lane's segment reduce: lane g is ``rsu_reduce_plain`` of lane g
    (with ``carry[g]`` updated in place).  One batched product computes the
    same sums but rounds unlike the one-lane product at larger chunks, so
    the lanes go one call each."""
    lanes = [rsu_reduce_plain(u, w, r, n_rsu, None if carry is None else carry[g], out_dtype)
             for g, (u, w, r) in enumerate(zip(updates, weights, rid))]
    partials = carry if carry is not None else torch.stack([p for p, _ in lanes])
    return partials, torch.stack([m for _, m in lanes])


def rsu_reduce_grid(updates: torch.Tensor, weights: torch.Tensor, rid: torch.Tensor,
                    n_rsu: int, carry=None, out_dtype=torch.float32):
    """G lanes' segment reduces -> (partials (G, R, P) in ``out_dtype``,
    mass (G, R) fp32).

    ``updates`` (G, K, P), ``weights`` (G, K), ``rid`` (G, K) int32 on the
    card; with ``carry`` (G, R, P, in ``out_dtype``) the partials are
    ``carry`` itself, updated in place.  CUDA tensors go to the kernel (one
    launch), CPU tensors to ``rsu_reduce_grid_plain``.
    """
    if updates.is_cuda:
        out = _launch("rsu_reduce_grid", updates, weights, rid, n_rsu, carry, out_dtype, 1)
        count_launch(__name__, "grid_launches")
        return out
    if updates.device.type != "cpu":
        raise ValueError(f"rsu_reduce_grid: unsupported device {updates.device}")
    return rsu_reduce_grid_plain(updates, weights, rid, n_rsu, carry, out_dtype)
