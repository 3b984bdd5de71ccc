"""V2X messages: CAM (self state) and CPM (perceived neighbours).

Noisy observations of the twin's ground truth as dense arrays
(``repro.core.messages``): CAMs are ``(N,)``, CPMs ``(N, MAX_PERCEIVED)``
with a ``valid`` mask for detections in range.  Up to ``DENSE_MAX_N``
vehicles both also take G lanes at once (a ``(G, N)`` twin, a
``scenarios.lane_view`` scenario, ``(G, 2)`` keys): every field gains a
leading G, and each lane's row is its one-lane message.

The neighbour search is the reference's ``(N, N)`` ring-distance top-k up
to ``DENSE_MAX_N`` vehicles.  Above it (a fleet of 100,000 would need a
40 GB distance matrix) a windowed search on the sorted ring finds the same
neighbour sets in ``O(N * MAX_PERCEIVED)`` memory (``nearest_windowed``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.rttg import ring_dist, table_scalar
from repro_torch.core.twin import TwinState
from repro_torch.utils import prng

CAM_POS_STD = 1.0
CAM_SPD_STD = 0.3
CPM_POS_STD = 3.0
CPM_SPD_STD = 1.0
PERCEPTION_RANGE_M = 150.0
MAX_PERCEIVED = 8
# Up to this many vehicles the neighbour search (and ``fusion``'s sums) use
# dense (N, N) tables; above it, the windowed search and the compact fusion.
DENSE_MAX_N = 4096
# Rows of the windowed search recomputed against all N (a count, like the
# kernels' launch counters).
dense_rows = 0
# Rows per batch of that recompute: at most this many (row, vehicle) pairs.
_RECOMPUTE_PAIRS = 1 << 24


def smallest_k(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis.

    ``jax.lax.top_k(-x, k)`` breaks ties toward the lower index;
    ``torch.topk`` promises no order, so take the first k of a stable sort.
    """
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def nearest_dense(pos: torch.Tensor, length, k: int):
    """The reference's search: ring distances to every vehicle, yourself at
    +1e9, the k smallest.  -> (dist (N, k), obj (N, k)); with ``(G, N)``
    positions and ``(G, 1)`` lengths, ``(G, N, k)`` each."""
    N = pos.shape[-1]
    d = ring_dist(pos[..., :, None], pos[..., None, :], table_scalar(length))
    d = d + 1e9 * torch.eye(N, dtype=torch.float32, device=pos.device)  # not yourself
    return smallest_k(d, k)


def _pair_keys(d: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as the pairs (d, j): d >= 0, and the bits of a
    non-negative float order as integers."""
    return (d.contiguous().view(torch.int32).to(torch.int64) << 32) | j


def _unpack(keys: torch.Tensor):
    d = (keys >> 32).to(torch.int32).view(torch.float32)
    return d, keys & 0xFFFFFFFF


def nearest_windowed(pos: torch.Tensor, length, k: int):
    """``nearest_dense``'s neighbour sets from the sorted ring.

    The candidates of a vehicle are the k vehicles on each side of it in the
    ring order (a stable sort of the positions).  Its k nearest by the true
    ring distance lie among them; the computed distance is within half an
    ulp of the ring length of the true one, and ties go to the lower index,
    so a vehicle outside the window can still win where the k-th distance
    comes within two ulps of the window's edges (equal positions, rounding
    at the wrap).  Those rows are recomputed against all N vehicles.  The
    result equals ``nearest_dense``'s in every row; the count of recomputed
    rows is added to ``dense_rows``.
    """
    global dense_rows
    N = pos.shape[0]
    device = pos.device
    length = torch.as_tensor(length, dtype=torch.float32, device=device)
    ar = torch.arange(N, device=device)
    order = torch.sort(pos, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = ar
    offs = torch.cat([torch.arange(-k, 0, device=device), torch.arange(1, k + 1, device=device)])
    cand = order[(rank[:, None] + offs[None, :]) % N]  # (N, 2k), the edges at 0 and -1
    d = ring_dist(pos[:, None], pos[cand], length)
    d = d + torch.where(cand == ar[:, None], 1e9, 0.0)
    keys = torch.sort(_pair_keys(d, cand), dim=1).values
    if N <= 2 * k:  # the window wraps onto itself: drop repeated candidates
        dup = torch.zeros_like(keys, dtype=torch.bool)
        dup[:, 1:] = keys[:, 1:] == keys[:, :-1]
        keys = torch.sort(torch.where(dup, torch.iinfo(torch.int64).max, keys), dim=1).values
    keys = keys[:, :k]
    if N > 2 * k + 1:  # vehicles outside the window exist
        # 2 ulps: one for the two distances' rounding, one for this subtraction's
        ulp = torch.nextafter(length, torch.full_like(length, math.inf)) - length
        kth = _unpack(keys[:, -1])[0]
        rows = torch.nonzero(kth >= torch.minimum(d[:, 0], d[:, -1]) - 2 * ulp)[:, 0]
        dense_rows += rows.numel()
        step = max(_RECOMPUTE_PAIRS // N, 1)
        for r in rows.split(step):
            dr = ring_dist(pos[r, None], pos[None, :], length)
            dr = dr + torch.where(ar[None, :] == r[:, None], 1e9, 0.0)
            keys[r] = torch.topk(_pair_keys(dr, ar.expand_as(dr)), k, dim=1, largest=False,
                                 sorted=True).values
    return _unpack(keys)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for ``(N,)`` values and ``(N, k)`` indices, lane by lane
    for ``(G, N)`` values and ``(G, N, k)`` indices."""
    return torch.gather(x, -1, idx.reshape(idx.shape[:-2] + (-1,))).reshape(idx.shape)


def emit_cams(state: TwinState, cfg, key: torch.Tensor) -> dict:
    """Every CAV reports its own state with GNSS-grade noise."""
    N = cfg.num_vehicles
    device = state.pos.device
    k1, k2, k3 = prng.split(prng.fold_in_str(key, "cam"), 3).unbind(-2)
    ids = torch.arange(N, device=device)
    return {
        "src": ids,
        "obj": ids,
        "pos": torch.remainder(
            state.pos + CAM_POS_STD * prng.normal(k1, (N,), device), cfg.ring_length_m
        ),
        "speed": state.speed + CAM_SPD_STD * prng.normal(k2, (N,), device),
        "accel": state.accel + 0.1 * prng.normal(k3, (N,), device),
        "var": torch.full((N,), CAM_POS_STD ** 2, dtype=torch.float32, device=device),
    }


def emit_cpms(state: TwinState, cfg, key: torch.Tensor) -> dict:
    """Each CAV perceives up to MAX_PERCEIVED nearest neighbours in range."""
    N, P = cfg.num_vehicles, MAX_PERCEIVED
    device = state.pos.device
    k1, k2, k3 = prng.split(prng.fold_in_str(key, "cpm"), 3).unbind(-2)
    search = nearest_dense if N <= DENSE_MAX_N else nearest_windowed
    dist_p, obj = search(state.pos, cfg.ring_length_m, P)
    valid = dist_p < PERCEPTION_RANGE_M
    scale = 1.0 + dist_p / PERCEPTION_RANGE_M
    pos_std = CPM_POS_STD * scale
    pos_n = pos_std * prng.normal(k1, (N, P), device)
    spd_n = CPM_SPD_STD * scale * prng.normal(k2, (N, P), device)
    return {
        "src": torch.arange(N, device=device)[:, None].expand(N, P),
        "obj": obj,
        "pos": torch.remainder(take(state.pos, obj) + pos_n, table_scalar(cfg.ring_length_m)),
        "speed": take(state.speed, obj) + spd_n,
        "accel": take(state.accel, obj) + 0.2 * prng.normal(k3, (N, P), device),
        "var": pos_std * pos_std,
        "valid": valid,
    }
