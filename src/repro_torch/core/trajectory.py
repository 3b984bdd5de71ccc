"""Stage 2: horizon prediction (``repro.core.trajectory``).

The deterministic OU-mean predictor: acceleration decays by
``1 - theta dt`` per step, speed is clipped, position wraps on the ring.
``predict_rttg`` rebuilds the future RTTG from the predicted kinematics.
"""
from __future__ import annotations

import torch

from repro_torch.core.rttg import RTTG, build_rttg


def horizon_steps(horizon_s: float, cfg) -> int:
    """Static Euler trip count of a prediction horizon."""
    return max(int(round(horizon_s / cfg.sim_dt_s)), 1)


def predict_kinematics(pos, speed, accel, n: int, cfg):
    """``n`` Euler steps of the OU-mean predictor on (N,) kinematics.

    The ``rttg_latency`` kernel runs exactly this loop, op for op.
    """
    dt = cfg.sim_dt_s
    for _ in range(n):
        accel = accel * cfg.ou_decay
        speed = torch.minimum(torch.clamp_min(speed + accel * dt, 1.0), cfg.v_max)
        pos = torch.remainder(pos + speed * dt, cfg.ring_length_m)
    return pos, speed, accel


def predict_rttg(rttg: RTTG, horizon_s: float, cfg) -> RTTG:
    """Propagate the fused RTTG ``horizon_s`` seconds forward."""
    pos, speed, accel = predict_kinematics(rttg.pos, rttg.speed, rttg.accel,
                                           horizon_steps(horizon_s, cfg), cfg)
    # prediction inflates position variance (process noise accumulates)
    var = rttg.pos_var + cfg.accel_var * horizon_s ** 3 / 3.0
    return build_rttg(rttg.t + horizon_s, pos, speed, accel, var, cfg)
