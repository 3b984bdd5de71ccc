"""Stage 2: horizon prediction (``repro.core.trajectory``).

The deterministic OU-mean predictor: acceleration decays by
``1 - theta dt`` per step, speed is clipped, position wraps on the ring.
"""
from __future__ import annotations

import torch


def horizon_steps(horizon_s: float, cfg) -> int:
    """Static Euler trip count of a prediction horizon."""
    return max(int(round(horizon_s / cfg.sim_dt_s)), 1)


def predict_kinematics(pos, speed, accel, n: int, cfg):
    """``n`` Euler steps of the OU-mean predictor on (N,) kinematics.

    The ``rttg_latency`` kernel runs exactly this loop, op for op.
    """
    dt = cfg.sim_dt_s
    decay = 1.0 - cfg.ou_theta * dt
    v_max = 3.0 * cfg.mean_speed_mps
    for _ in range(n):
        accel = accel * decay
        speed = torch.minimum(torch.clamp_min(speed + accel * dt, 1.0), v_max)
        pos = torch.remainder(pos + speed * dt, cfg.ring_length_m)
    return pos, speed, accel
