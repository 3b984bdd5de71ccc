"""Traffic digital twin: ground-truth kinematics on a ring road (``repro.core.twin``).

N CAVs with Ornstein-Uhlenbeck acceleration noise; the platoon family
correlates the noise within convoys, the hetero_fleet family mixes compute
tiers, and rush_hour / day_cycle drag realized displacement through
``congestion_factor``.  ``cfg`` is a ``ScenarioParams``; ``TrafficTwin``
lifts a ``TrafficConfig`` (``scenarios.traffic_params``), owns a twin on one
device and advances it in ``sim_dt_s`` steps.

``advance_twin``'s sub-step path also advances G lanes at once: a
``TwinState`` whose leaves are ``(G, N)`` and whose ``t`` is ``(G, 1)``, a
``scenarios.lane_view`` scenario, ``(G, 2)`` keys and ``(G, 1)`` durations.
Each lane's row is then its one-lane advance, element for element.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.rttg import congestion_factor
from repro_torch.core.scenarios import traffic_params
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


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

    ``key`` may carry leading batch dims (one key per substep, and then one
    per lane); the result is ``key.shape[:-1] + (n,)``.  With coupling c the innovation is
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
    speed = torch.minimum(torch.clamp_min(speed, 2.0), cfg.v_init_max)
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


def _euler_step(state: TwinState, cfg, eps: torch.Tensor, dt: float) -> TwinState:
    sqrt_dt = torch.sqrt(torch.as_tensor(dt, dtype=torch.float32, device=state.pos.device))
    accel = state.accel - cfg.ou_theta * state.accel * dt + cfg.accel_std * sqrt_dt * eps
    speed = torch.minimum(torch.clamp_min(state.speed + accel * dt, 1.0), cfg.v_max)
    # rush-hour congestion drags realized displacement, not the OU speed
    v_eff = speed / congestion_factor(state.t, cfg)
    pos = torch.remainder(state.pos + v_eff * dt, cfg.ring_length_m)
    return state._replace(t=state.t + dt, pos=pos, speed=speed, accel=accel)


def twin_step(state: TwinState, cfg, key: torch.Tensor, dt: float) -> TwinState:
    """One OU + kinematic Euler step of ``dt`` seconds."""
    eps = ou_innovations(key, state.pos.shape[0], cfg, state.pos.device)
    return _euler_step(state, cfg, eps, dt)


def advance_twin(state: TwinState, cfg, key: torch.Tensor, duration,
                 num_substeps: int = 0) -> TwinState:
    """Advance ``duration`` seconds.

    With ``num_substeps > 0`` the duration is split into that many equal
    sub-steps, with the exact OU transition (drift ``exp(-theta dt)``,
    variance ``sigma^2 (1 - exp(-2 theta dt)) / (2 theta)``), which keeps
    the acceleration process dt-invariant.  With ``num_substeps = 0`` it
    takes ``max(round(duration / sim_dt_s), 1)`` Euler steps of
    ``sim_dt_s`` (``twin_step``), the count rounded half to even in
    float32 as ``jnp.round`` rounds it.  Either way sub-step i draws its
    innovations from ``fold_in(key, i)``, all in one batch.  The sub-step
    path takes G lanes too (the module docstring): the innovations are then
    ``(num_substeps, G, N)``, sub-step first.
    """
    device = state.pos.device
    if num_substeps <= 0:
        dt = cfg.sim_dt_s
        d = torch.as_tensor(duration, dtype=torch.float32, device=device)
        n = max(int(torch.round(d / dt)), 1)
        eps = ou_innovations(prng.fold_in(key, torch.arange(n)), state.pos.shape[0], cfg,
                             device)
        for i in range(n):
            state = _euler_step(state, cfg, eps[i], dt)
        return state
    dt = torch.as_tensor(duration, dtype=torch.float32, device=device) / num_substeps
    decay = torch.exp(-cfg.ou_theta * dt)
    noise_std = cfg.accel_std * torch.sqrt(
        (1.0 - decay * decay) / torch.clamp_min(2.0 * cfg.ou_theta, 1e-6)
    )
    steps = torch.arange(num_substeps).reshape((num_substeps,) + (1,) * (key.dim() - 1))
    eps = ou_innovations(prng.fold_in(key, steps), state.pos.shape[-1], cfg, device)
    t, pos, speed, accel = state.t, state.pos, state.speed, state.accel
    for i in range(num_substeps):
        accel = accel * decay + noise_std * eps[i]
        speed = torch.minimum(torch.clamp_min(speed + accel * dt, 1.0), cfg.v_max)
        v_eff = speed / congestion_factor(t, cfg)  # rush-hour drag
        pos = torch.remainder(pos + v_eff * dt, cfg.ring_length_m)
        t = t + dt
    return state._replace(t=t, pos=pos, speed=speed, accel=accel)


class TrafficTwin:
    """Owns the ground-truth state of one ``TrafficConfig`` and advances it.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; raises when CUDA is
    asked for and no card is present.
    """

    def __init__(self, cfg, key: torch.Tensor, device="cuda"):
        self.cfg = cfg
        self.key = prng.fold_in_str(key, "traffic-twin")
        self.device = resolve_device(device)
        self.params = traffic_params(cfg, self.device)

    def init_state(self) -> TwinState:
        return init_twin_state(self.params, prng.fold_in_str(self.key, "init"), self.device)

    def step(self, state: TwinState, key: torch.Tensor, dt: float) -> TwinState:
        return twin_step(state, self.params, key, dt)

    def advance(self, state: TwinState, key: torch.Tensor, duration: float) -> TwinState:
        """Advance ``duration`` seconds in ``sim_dt_s`` steps."""
        return advance_twin(state, self.params, key, duration)
