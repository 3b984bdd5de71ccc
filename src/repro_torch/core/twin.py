"""Traffic digital twin: ground-truth kinematics on a ring road (``repro.core.twin``).

N CAVs with Ornstein-Uhlenbeck acceleration noise; the platoon family
correlates the noise within convoys, the hetero_fleet family mixes compute
tiers, and rush_hour / day_cycle drag realized displacement through
``congestion_factor``.  ``cfg`` is a ``ScenarioParams``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rttg import congestion_factor
from repro_torch.utils import prng


class TwinState(NamedTuple):
    t: torch.Tensor  # () f32 sim time (s)
    pos: torch.Tensor  # (N,) arc position along the ring (m)
    speed: torch.Tensor  # (N,) m/s
    accel: torch.Tensor  # (N,) m/s^2
    lane: torch.Tensor  # (N,) int64 lane index
    compute_factor: torch.Tensor  # (N,) per-client compute-time multiplier


def _platoon_size(cfg) -> int:
    return max(int(getattr(cfg, "platoon_size", 1) or 1), 1)


def convoy_ids(cfg, n: int, device) -> torch.Tensor:
    """(N,) convoy membership: vehicle i rides convoy i // platoon_size."""
    return torch.arange(n, device=device) // _platoon_size(cfg)


def ou_innovations(key: torch.Tensor, n: int, cfg, device) -> torch.Tensor:
    """Standard-normal OU innovations, convoy-correlated under platoon.

    ``key`` may carry leading batch dims (one key per substep); the result
    is ``key.shape[:-1] + (n,)``.  With coupling c the innovation is
    ``sqrt(1-c) own + sqrt(c) shared``, one shared draw per convoy; at
    c == 0 it is exactly the independent draw.
    """
    eps = prng.normal(key, (n,), device)
    size = _platoon_size(cfg)
    if size <= 1:
        return eps
    c = torch.clamp(cfg.platoon_coupling, 0.0, 1.0)
    n_conv = (n + size - 1) // size
    shared = prng.normal(prng.fold_in_str(key, "platoon"), (n_conv,), device)
    shared = shared[..., convoy_ids(cfg, n, device)]
    return torch.where(c > 0.0, torch.sqrt(1.0 - c) * eps + torch.sqrt(c) * shared, eps)


def fleet_compute_factors(cfg, key: torch.Tensor, n: int, device) -> torch.Tensor:
    """(N,) compute-time multipliers: lognormal jitter x sedan/truck/bus tier."""
    base = torch.exp(cfg.compute_lognorm_std * prng.normal(key, (n,), device))
    bus, truck = cfg.fleet_bus_frac, cfg.fleet_truck_frac
    u = prng.uniform(prng.fold_in_str(key, "fleet-tier"), (n,), device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    tier = torch.where(u < bus, cfg.fleet_bus_factor,
                       torch.where(u < bus + truck, cfg.fleet_truck_factor, one))
    return base * tier


def init_twin_state(cfg, key: torch.Tensor, device) -> TwinState:
    """Fresh ground-truth state (``key`` is the twin's init key)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    N = cfg.num_vehicles
    pos = prng.uniform(k1, (N,), 0.0, cfg.ring_length_m, device)
    speed = cfg.mean_speed_mps + cfg.speed_std_mps * prng.normal(k2, (N,), device)
    speed = torch.minimum(torch.clamp_min(speed, 2.0), 2.5 * cfg.mean_speed_mps)
    lane = prng.randint(k3, (N,), 0, cfg.num_lanes, device)
    compute = fleet_compute_factors(cfg, k4, N, device)
    size = _platoon_size(cfg)
    if size > 1:
        # convoy members trail their leader at platoon_gap_m with its speed;
        # selected by the coupling so other scenarios keep the uniform spawn
        cid = convoy_ids(cfg, N, device)
        rank = torch.arange(N, device=device) % size
        leader = torch.clamp_max(cid * size, N - 1)
        conv_pos = torch.remainder(
            pos[leader] - rank.to(torch.float32) * cfg.platoon_gap_m, cfg.ring_length_m
        )
        coupled = cfg.platoon_coupling > 0.0
        pos = torch.where(coupled, conv_pos, pos)
        speed = torch.where(coupled, speed[leader], speed)
    return TwinState(
        t=torch.zeros((), dtype=torch.float32, device=device),
        pos=pos,
        speed=speed,
        accel=torch.zeros((N,), dtype=torch.float32, device=device),
        lane=lane,
        compute_factor=compute,
    )


def advance_twin(state: TwinState, cfg, key: torch.Tensor, duration,
                 num_substeps: int) -> TwinState:
    """Advance ``duration`` seconds in ``num_substeps`` equal sub-steps.

    The exact OU transition (drift ``exp(-theta dt)``, variance
    ``sigma^2 (1 - exp(-2 theta dt)) / (2 theta)``) keeps the acceleration
    process dt-invariant.  Sub-step i draws its innovations from
    ``fold_in(key, i)``; all sub-steps' draws are made in one batch.
    """
    if num_substeps <= 0:
        raise NotImplementedError(
            "the fixed sim_dt_s sub-step path of advance_twin is not ported "
            "(see ROADMAP.md); the round core uses num_substeps > 0"
        )
    device = state.pos.device
    dt = torch.as_tensor(duration, dtype=torch.float32, device=device) / num_substeps
    decay = torch.exp(-cfg.ou_theta * dt)
    noise_std = cfg.accel_std * torch.sqrt(
        (1.0 - decay * decay) / torch.clamp_min(2.0 * cfg.ou_theta, 1e-6)
    )
    keys = prng.fold_in(key, torch.arange(num_substeps))
    eps = ou_innovations(keys, state.pos.shape[0], cfg, device)
    t, pos, speed, accel = state.t, state.pos, state.speed, state.accel
    v_max = 3.0 * cfg.mean_speed_mps
    for i in range(num_substeps):
        accel = accel * decay + noise_std * eps[i]
        speed = torch.minimum(torch.clamp_min(speed + accel * dt, 1.0), v_max)
        v_eff = speed / congestion_factor(t, cfg)  # rush-hour drag
        pos = torch.remainder(pos + v_eff * dt, cfg.ring_length_m)
        t = t + dt
    return state._replace(t=t, pos=pos, speed=speed, accel=accel)
