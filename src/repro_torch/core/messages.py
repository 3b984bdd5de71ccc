"""V2X messages: CAM (self state) and CPM (perceived neighbours).

Noisy observations of the twin's ground truth as dense arrays
(``repro.core.messages``): CAMs are ``(N,)``, CPMs ``(N, MAX_PERCEIVED)``
with a ``valid`` mask for detections in range.
"""
from __future__ import annotations

import torch

from repro_torch.core.rttg import ring_dist
from repro_torch.core.twin import TwinState
from repro_torch.utils import prng

CAM_POS_STD = 1.0
CAM_SPD_STD = 0.3
CPM_POS_STD = 3.0
CPM_SPD_STD = 1.0
PERCEPTION_RANGE_M = 150.0
MAX_PERCEIVED = 8


def smallest_k(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis.

    ``jax.lax.top_k(-x, k)`` breaks ties toward the lower index;
    ``torch.topk`` promises no order, so take the first k of a stable sort.
    """
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def emit_cams(state: TwinState, cfg, key: torch.Tensor) -> dict:
    """Every CAV reports its own state with GNSS-grade noise."""
    N = cfg.num_vehicles
    device = state.pos.device
    k1, k2, k3 = prng.split(prng.fold_in_str(key, "cam"), 3)
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
    k1, k2, k3 = prng.split(prng.fold_in_str(key, "cpm"), 3)
    d = ring_dist(state.pos[:, None], state.pos[None, :], cfg.ring_length_m)
    d = d + 1e9 * torch.eye(N, dtype=torch.float32, device=device)  # not yourself
    dist_p, obj = smallest_k(d, P)
    valid = dist_p < PERCEPTION_RANGE_M
    scale = 1.0 + dist_p / PERCEPTION_RANGE_M
    pos_std = CPM_POS_STD * scale
    pos_n = pos_std * prng.normal(k1, (N, P), device)
    spd_n = CPM_SPD_STD * scale * prng.normal(k2, (N, P), device)
    return {
        "src": torch.arange(N, device=device)[:, None].expand(N, P),
        "obj": obj,
        "pos": torch.remainder(state.pos[obj] + pos_n, cfg.ring_length_m),
        "speed": state.speed[obj] + spd_n,
        "accel": state.accel[obj] + 0.2 * prng.normal(k3, (N, P), device),
        "var": pos_std * pos_std,
        "valid": valid,
    }
