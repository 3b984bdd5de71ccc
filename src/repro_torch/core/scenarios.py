"""Scenario catalog and the float32 traffic parameters (``repro.core.scenarios``).

The catalog is data: each family returns a ``TrafficConfig`` whose fields the
twin, the radio model and the kernels read.  ``ScenarioParams`` is the view
every core form computes with: each field the JAX package traces is a
float32 0-dim tensor on the run's device, so scalar arithmetic rounds in
float32 as it does there; fields that fix shapes or trip counts stay Python
numbers.

A few constants the reference forms from config values before they meet an
array (``3 mean_speed``, ``1 - theta dt``, ``2 pi / L``, ...) round
differently by the kind of config it is given: in float32 inside the traced
round (a ``ScenarioParams``), in double precision and then once to float32
in the selector and the twin (a ``TrafficConfig`` of Python floats).  The
two lifts below are the one place that choice is made: ``scenario_params``
for the round, ``traffic_params`` for ``ContextualSelector`` and
``TrafficTwin``.  ``stack_scenarios`` stacks round lifts along a leading
grid axis (the experiment engine calls it to refuse a grid whose static
fields differ), ``scenario_lane`` gives one lane of a stack back, and
``lane_view`` gives the whole stack as the batched round reads it: every
lane field ``(G, 1)``, so that a per-client expression over ``(G, N)``
broadcasts each lane's value along its own row, unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Callable, Dict, Sequence, Union

import torch

from repro_torch.config import TrafficConfig
from repro_torch.core.rttg import n_rsu_of

_TRACED_FIELDS = (
    "ring_length_m", "rsu_spacing_m", "mean_speed_mps", "speed_std_mps",
    "accel_std", "ou_theta", "carrier_ghz", "bandwidth_hz", "eirp_dbm",
    "noise_dbm", "snr_min_db", "backhaul_s", "queue_s_per_vehicle",
    "overhead_bytes", "rush_amp", "rush_period_s", "rsu_outage_frac",
    "platoon_coupling", "platoon_gap_m", "compute_lognorm_std",
    "fleet_truck_frac", "fleet_bus_frac", "fleet_truck_factor",
    "fleet_bus_factor", "day_amp", "day_period_s", "day_harmonic2",
)
_STATIC_FIELDS = (
    "num_vehicles", "num_lanes", "n_rsu", "cam_rate_hz", "sim_dt_s",
    "predict_horizon_s", "platoon_size",
)


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    """Duck-types ``TrafficConfig``: float32 0-dim tensors + static numbers."""

    ring_length_m: torch.Tensor
    rsu_spacing_m: torch.Tensor
    mean_speed_mps: torch.Tensor
    speed_std_mps: torch.Tensor
    accel_std: torch.Tensor
    ou_theta: torch.Tensor
    carrier_ghz: torch.Tensor
    bandwidth_hz: torch.Tensor
    eirp_dbm: torch.Tensor
    noise_dbm: torch.Tensor
    snr_min_db: torch.Tensor
    backhaul_s: torch.Tensor
    queue_s_per_vehicle: torch.Tensor
    overhead_bytes: torch.Tensor
    rush_amp: torch.Tensor
    rush_period_s: torch.Tensor
    rsu_outage_frac: torch.Tensor
    platoon_coupling: torch.Tensor
    platoon_gap_m: torch.Tensor
    compute_lognorm_std: torch.Tensor
    fleet_truck_frac: torch.Tensor
    fleet_bus_frac: torch.Tensor
    fleet_truck_factor: torch.Tensor
    fleet_bus_factor: torch.Tensor
    day_amp: torch.Tensor
    day_period_s: torch.Tensor
    day_harmonic2: torch.Tensor
    v_max: torch.Tensor  # 3 mean_speed: the twin's and the predictor's speed clip
    v_init_max: torch.Tensor  # 2.5 mean_speed: the spawn speed clip
    ou_decay: torch.Tensor  # 1 - ou_theta sim_dt_s: the predictor's per-step drift
    rad_per_m: torch.Tensor  # 2 pi / ring_length_m
    m_per_rad: torch.Tensor  # ring_length_m / (2 pi)
    # accel_std^2 (prediction's variance inflation); a Python float in the
    # traffic_params view, whose h-dependent product the reference forms in double
    accel_var: Union[torch.Tensor, float]
    num_vehicles: int
    num_lanes: int
    n_rsu: int
    cam_rate_hz: float
    sim_dt_s: float
    predict_horizon_s: float
    platoon_size: int


def _derived(c) -> dict:
    """The constants of the module docstring; Python arithmetic on ``c``'s
    fields rounds them as the reference does for that kind of value."""
    return {"v_max": 3.0 * c.mean_speed_mps, "v_init_max": 2.5 * c.mean_speed_mps,
            "ou_decay": 1.0 - c.ou_theta * c.sim_dt_s,
            "rad_per_m": 2 * math.pi / c.ring_length_m,
            "m_per_rad": c.ring_length_m / (2 * math.pi), "accel_var": c.accel_std ** 2}


def _lift(cfg: TrafficConfig, device, in_double: bool) -> ScenarioParams:
    values = torch.tensor([float(getattr(cfg, f)) for f in _TRACED_FIELDS],
                          dtype=torch.float32, device=device)
    traced = {f: values[i] for i, f in enumerate(_TRACED_FIELDS)}
    if in_double:
        derived = _derived(cfg)
        accel_var = derived.pop("accel_var")
        lifted = torch.tensor(list(derived.values()), dtype=torch.float32, device=device)
        derived = dict(zip(derived, lifted), accel_var=accel_var)
    else:
        derived = _derived(SimpleNamespace(**traced, sim_dt_s=cfg.sim_dt_s))
    return ScenarioParams(
        **traced,
        **derived,
        num_vehicles=cfg.num_vehicles,
        num_lanes=cfg.num_lanes,
        n_rsu=n_rsu_of(cfg),
        cam_rate_hz=cfg.cam_rate_hz,
        sim_dt_s=cfg.sim_dt_s,
        predict_horizon_s=cfg.predict_horizon_s,
        platoon_size=cfg.platoon_size,
    )


def scenario_params(cfg: TrafficConfig, device="cpu") -> ScenarioParams:
    """Lift a concrete ``TrafficConfig`` into float32 tensors on ``device``,
    as the reference's traced round sees it."""
    return _lift(cfg, device, in_double=False)


def traffic_params(cfg: TrafficConfig, device="cpu") -> ScenarioParams:
    """Lift a ``TrafficConfig`` as the reference's selector and twin see it:
    the derived constants formed in double precision."""
    return _lift(cfg, device, in_double=True)


def data_signature(cfg: TrafficConfig) -> tuple:
    """Hashable summary of the fields that shape an experiment's client data.

    Client shards derive from the experiment key and the twin's spawn
    layout (the home regions).  Outside the platoon family the normalized
    spawn positions depend on the key alone, so lanes sharing (strategy,
    seed) share one ``RoundData`` row; platoon spawn regroups vehicles
    behind convoy leaders, so its rows carry their own signature.
    """
    if cfg.platoon_coupling > 0.0:
        return ("platoon", cfg.platoon_size, float(cfg.platoon_gap_m),
                float(cfg.ring_length_m))
    return ()


_LANE_FIELDS = tuple(f.name for f in dataclasses.fields(ScenarioParams)
                     if f.name not in _STATIC_FIELDS)


def stack_scenarios(params: Sequence[ScenarioParams]) -> ScenarioParams:
    """Stack scenarios along a leading grid axis (static fields must agree).

    Every tensor field, the derived ones included, becomes ``(G,)``.  The
    ``traffic_params`` view (``accel_var`` a Python float) is refused: the
    grid lifts its scenarios with ``scenario_params``.
    """
    metas = {tuple(getattr(p, f) for f in _STATIC_FIELDS) for p in params}
    if len(metas) != 1:
        raise ValueError(
            f"scenarios disagree on static fields {_STATIC_FIELDS}: {sorted(metas)}"
        )
    if not all(isinstance(p.accel_var, torch.Tensor) for p in params):
        raise ValueError("stack_scenarios takes scenario_params views, not traffic_params")
    return dataclasses.replace(
        params[0], **{f: torch.stack([getattr(p, f) for p in params]) for f in _LANE_FIELDS})


def scenario_lane(stacked: ScenarioParams, g: int) -> ScenarioParams:
    """Lane ``g`` of a ``stack_scenarios`` stack: 0-dim views of its row."""
    return dataclasses.replace(stacked, **{f: getattr(stacked, f)[g] for f in _LANE_FIELDS})


def lane_view(stacked: ScenarioParams) -> ScenarioParams:
    """A ``stack_scenarios`` stack with every lane field ``(G, 1)``: the
    batched round's scenario (static fields as they are)."""
    return dataclasses.replace(stacked, **{f: getattr(stacked, f)[:, None] for f in _LANE_FIELDS})


def ring(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """The paper's default: 10 km urban ring, ~50 km/h."""
    return TrafficConfig(num_vehicles=num_vehicles, **kw)


def highway(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """Sparse fast traffic: 20 km loop, RSUs every 2 km, ~110 km/h."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=20_000.0,
                         rsu_spacing_m=2_000.0, mean_speed_mps=30.0,
                         speed_std_mps=4.0, accel_std=0.5,
                         queue_s_per_vehicle=0.008, **kw)


def urban_grid(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """Dense slow grid traffic: 5 km loop, RSUs every 500 m, ~30 km/h."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=5_000.0,
                         rsu_spacing_m=500.0, mean_speed_mps=8.0,
                         speed_std_mps=3.0, accel_std=1.2,
                         queue_s_per_vehicle=0.015, **kw)


def rush_hour(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """Commuter arterial whose density swells to 3.5x at the wave peak."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=8_000.0,
                         rsu_spacing_m=800.0, mean_speed_mps=10.0,
                         speed_std_mps=4.0, accel_std=1.0,
                         queue_s_per_vehicle=0.012, rush_amp=2.5,
                         rush_period_s=600.0, **kw)


def rsu_outage(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """A 12 km ring where a contiguous 40% of RSUs are dark."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=12_000.0,
                         rsu_spacing_m=1_200.0, mean_speed_mps=16.0,
                         rsu_outage_frac=0.4, **kw)


def platoon(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """Convoys that share 80% of their OU acceleration noise."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=15_000.0,
                         rsu_spacing_m=1_500.0, mean_speed_mps=22.0,
                         speed_std_mps=3.0, accel_std=0.9,
                         queue_s_per_vehicle=0.010, platoon_coupling=0.8,
                         platoon_gap_m=30.0, **kw)


def hetero_fleet(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """Sedan/truck/bus fleet: 30% trucks at 1.8x, 10% buses at 3.2x compute."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=11_000.0,
                         rsu_spacing_m=1_100.0, mean_speed_mps=12.0,
                         speed_std_mps=5.0, fleet_truck_frac=0.30,
                         fleet_bus_frac=0.10, fleet_truck_factor=1.8,
                         fleet_bus_factor=3.2, compute_lognorm_std=0.25, **kw)


def day_cycle(num_vehicles: int = 100, **kw) -> TrafficConfig:
    """Rush waves riding a two-harmonic daily envelope."""
    return TrafficConfig(num_vehicles=num_vehicles, ring_length_m=9_000.0,
                         rsu_spacing_m=900.0, mean_speed_mps=11.0,
                         speed_std_mps=4.0, accel_std=1.0,
                         queue_s_per_vehicle=0.012, rush_amp=1.5,
                         rush_period_s=600.0, day_amp=2.0,
                         day_period_s=7_200.0, day_harmonic2=0.6, **kw)


SCENARIOS: Dict[str, Callable[..., TrafficConfig]] = {
    "ring": ring,
    "highway": highway,
    "urban_grid": urban_grid,
    "rush_hour": rush_hour,
    "rsu_outage": rsu_outage,
    "platoon": platoon,
    "hetero_fleet": hetero_fleet,
    "day_cycle": day_cycle,
}


def scenario_config(name: str, num_vehicles: int = 100, **kw) -> TrafficConfig:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name](num_vehicles=num_vehicles, **kw)
