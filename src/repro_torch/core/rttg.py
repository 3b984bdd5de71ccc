"""Road Traffic Topology Graph: the fused C-ITS snapshot (``repro.core.rttg``).

Nodes are CAVs with kinematic attributes; edges are V2V adjacency within
range and V2I attachment to the nearest live RSU.  Besides the ``RTTG``
tuple, the module holds the pure forms the round core and the
``rttg_latency`` kernel share: ring distance, RSU positions and liveness,
the congestion schedule and the attachment with per-RSU load.  ``cfg`` is a
``ScenarioParams`` (``core.scenarios``) except where a function says so.
The pure forms also take G lanes at once: ``(G, N)`` kinematics with a
``scenarios.lane_view`` scenario (every field ``(G, 1)``), each lane's row
then its one-lane result (``rsu_geometry``'s tables become ``(G, N, R)``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

V2V_RANGE_M = 300.0


class RTTG(NamedTuple):
    t: torch.Tensor  # () f32 snapshot time
    pos: torch.Tensor  # (N,) fused arc position
    speed: torch.Tensor  # (N,)
    accel: torch.Tensor  # (N,)
    pos_var: torch.Tensor  # (N,) fused position variance (fusion confidence)
    rsu_id: torch.Tensor  # (N,) int64 nearest-live-RSU attachment
    rsu_dist: torch.Tensor  # (N,) 3D distance to the attached RSU (m)
    load: torch.Tensor  # (N,) vehicles on the same RSU
    adj: torch.Tensor  # (N, N) bool V2V adjacency


def table_scalar(x):
    """A scenario field as a per-client table ``(..., N, M)`` reads it: a
    0-dim field as it is, a lane view's ``(G, 1)`` field as ``(G, 1, 1)``."""
    return x[..., None] if isinstance(x, torch.Tensor) and x.dim() else x


def ring_dist(a, b, length):
    """Shortest arc distance on a ring of circumference ``length``.

    Keep the op order (abs, then min against the complement): the kernel
    evaluates exactly this expression.
    """
    d = torch.abs(a - b)
    return torch.minimum(d, length - d)


def n_rsu_of(cfg) -> int:
    """Static RSU count of a ``TrafficConfig`` or ``ScenarioParams``."""
    n = getattr(cfg, "n_rsu", None)
    if n is not None:
        return n
    return max(int(cfg.ring_length_m / cfg.rsu_spacing_m), 1)


def rsu_positions(cfg) -> torch.Tensor:
    """(n_rsu,) arc positions of the RSUs."""
    device = cfg.ring_length_m.device
    return torch.arange(n_rsu_of(cfg), dtype=torch.float32, device=device) * cfg.rsu_spacing_m


def day_envelope(t, cfg) -> torch.Tensor:
    """``1 + day_amp (sin^2(pi t/T) + day_harmonic2 sin^2(2 pi t/T))``."""
    t = torch.as_tensor(t, dtype=torch.float32, device=cfg.day_amp.device)
    x = math.pi * t / torch.clamp_min(cfg.day_period_s, 1e-3)
    s1, s2 = torch.sin(x), torch.sin(2.0 * x)
    return 1.0 + cfg.day_amp * (s1 * s1 + cfg.day_harmonic2 * s2 * s2)


def congestion_factor(t, cfg) -> torch.Tensor:
    """Density multiplier ``1 + rush_amp sin^2(pi t / rush_period) envelope``."""
    t = torch.as_tensor(t, dtype=torch.float32, device=cfg.rush_amp.device)
    phase = torch.sin(math.pi * t / torch.clamp_min(cfg.rush_period_s, 1e-3))
    return 1.0 + cfg.rush_amp * phase * phase * day_envelope(t, cfg)


def rsu_up_mask(cfg) -> torch.Tensor:
    """(n_rsu,) bool: RSUs whose index centre lies past ``rsu_outage_frac``."""
    n = n_rsu_of(cfg)
    device = cfg.rsu_outage_frac.device
    centers = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    return centers >= cfg.rsu_outage_frac


def rsu_geometry(pos: torch.Tensor, cfg):
    """Nearest live RSU id, 3D distance and per-RSU load for arc positions.

    Dark RSUs never win the argmin (first index on ties).  The load is the
    integer count of clients on the same RSU (of the same lane), exact in
    any summation order.  ``pos`` is ``(N,)`` or, with a lane view, ``(G, N)``.
    """
    rsu_pos = rsu_positions(cfg)
    d_along = ring_dist(pos[..., :, None], rsu_pos[..., None, :], table_scalar(cfg.ring_length_m))
    d_along = torch.where(rsu_up_mask(cfg)[..., None, :], d_along, math.inf)
    rid = torch.argmin(d_along, dim=-1)
    d_min = torch.gather(d_along, -1, rid[..., None])[..., 0]
    dist3d = torch.sqrt(d_min * d_min + 225.0 + 25.0)  # lateral offset, mast height
    counts = torch.zeros(rid.shape[:-1] + (rsu_pos.shape[-1],), dtype=torch.int64,
                         device=rid.device).scatter_add_(-1, rid, torch.ones_like(rid))
    return rid, dist3d, torch.gather(counts, -1, rid).to(torch.float32)


def build_rttg(t, pos, speed, accel, pos_var, cfg) -> RTTG:
    """The RTTG of fused (or predicted) kinematics: RSU geometry and the
    ``(N, N)`` V2V adjacency within ``V2V_RANGE_M``."""
    rid, dist3d, load = rsu_geometry(pos, cfg)
    adj = ring_dist(pos[:, None], pos[None, :], cfg.ring_length_m) < V2V_RANGE_M
    return RTTG(t=torch.as_tensor(t, dtype=torch.float32, device=pos.device), pos=pos,
                speed=speed, accel=accel, pos_var=pos_var, rsu_id=rid, rsu_dist=dist3d,
                load=load, adj=adj)
