"""Fused RTTG -> latency geometry chain: CUDA kernel and its plain version.

Port of ``repro/kernels/rttg_latency.py`` (Pallas ``_chain_kernel``).  Per
client: [predict n Euler steps] -> attach to the nearest live RSU -> per-RSU
load -> SNR / latency -> connectivity (and optionally the RSU id).

``rttg_latency`` dispatches on the tensors' device: CUDA tensors launch the
hand-written kernel (``csrc/rttg_latency.cu``), CPU tensors run
``rttg_latency_plain``, the composition of the core pure forms chained as
``repro/kernels/ref.py::rttg_latency`` chains them.  There is no fallback
from one to the other.  The PRNG stays outside: the connection-rate
Bernoulli mask comes in as ``forced``.
"""
from __future__ import annotations

import torch

from repro_torch.core.network import (
    connected_from_snr,
    latency_from_geometry,
    snr_from_dist,
)
from repro_torch.core.rttg import n_rsu_of, rsu_geometry, rsu_up_mask
from repro_torch.core.trajectory import horizon_steps, predict_kinematics

# Layout of the packed float32 scalar operand (the S_* enum of the .cu source).
SCALARS = (
    "t", "model_bytes", "ring_length_m", "rsu_spacing_m", "ou_theta",
    "mean_speed_mps", "carrier_ghz", "eirp_dbm", "noise_dbm", "snr_min_db",
    "bandwidth_hz", "overhead_bytes", "backhaul_s", "queue_s_per_vehicle",
    "rush_amp", "rush_period_s", "day_amp", "day_period_s", "day_harmonic2",
)

# Kernel launches made by ``rttg_latency`` (one per call on CUDA tensors).
launches = 0


def rttg_latency_plain(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                       want_rid=False):
    """(N,) kinematics -> (latency f32, connected bool[, rid int32]).

    The unfused composition: predict_kinematics -> rsu_geometry ->
    latency_from_geometry / connected_from_snr.
    """
    t = torch.as_tensor(t, dtype=torch.float32, device=pos.device)
    if predict:
        n = horizon_steps(cfg.predict_horizon_s, cfg)
        pos, speed, accel = predict_kinematics(pos, speed, accel, n, cfg)
        t = t + cfg.predict_horizon_s
    rid, dist3d, load = rsu_geometry(pos, cfg)
    lat = latency_from_geometry(t, speed, dist3d, load, model_bytes, cfg)
    conn = connected_from_snr(snr_from_dist(dist3d, cfg), cfg, forced)
    if want_rid:
        return lat, conn, rid.to(torch.int32)
    return lat, conn


def pack_scalars(t, model_bytes, cfg, device) -> torch.Tensor:
    """The (19,) float32 scalar operand, built on the device (no host sync)."""
    vals = {"t": t, "model_bytes": model_bytes}
    row = [torch.as_tensor(vals[n] if n in vals else getattr(cfg, n),
                           dtype=torch.float32, device=device).reshape(())
           for n in SCALARS]
    return torch.stack(row)


def _check_vector(name, x, n, dtype, device):
    if x.device != device or x.dtype != dtype or x.shape != (n,) or not x.is_contiguous():
        raise ValueError(
            f"rttg_latency: {name} must be a contiguous ({n},) {dtype} tensor on "
            f"{device}, got {tuple(x.shape)} {x.dtype} on {x.device}"
        )


def _rttg_latency_cuda(pos, speed, accel, t, model_bytes, forced, cfg, predict,
                       want_rid):
    from repro_torch.kernels.build import check, library

    global launches
    device = pos.device
    n = pos.shape[0]
    n_rsu = n_rsu_of(cfg)
    if n < 1 or n_rsu < 1 or n_rsu > 32768:
        raise ValueError(f"rttg_latency: need N >= 1 and 1 <= R <= 32768, got N={n}, R={n_rsu}")
    for name, x in (("pos", pos), ("speed", speed), ("accel", accel)):
        _check_vector(name, x, n, torch.float32, device)
    if forced is not None:
        _check_vector("forced", forced, n, torch.bool, device)
    scalars = pack_scalars(t, model_bytes, cfg, device)
    live = rsu_up_mask(cfg).to(device=device, dtype=torch.uint8).contiguous()
    n_steps = horizon_steps(cfg.predict_horizon_s, cfg) if predict else 0
    horizon_s = float(cfg.predict_horizon_s) if predict else 0.0
    counts = torch.empty((n_rsu,), dtype=torch.int32, device=device)
    lat = torch.empty((n,), dtype=torch.float32, device=device)
    conn = torch.empty((n,), dtype=torch.bool, device=device)
    rid = torch.empty((n,), dtype=torch.int32, device=device) if want_rid else None
    stream = torch.cuda.current_stream(device).cuda_stream
    status = library().rttg_latency_launch(
        scalars.data_ptr(), live.data_ptr(), n_rsu, pos.data_ptr(),
        speed.data_ptr(), accel.data_ptr(),
        None if forced is None else forced.data_ptr(), n, n_steps,
        float(cfg.sim_dt_s), horizon_s, counts.data_ptr(), lat.data_ptr(),
        conn.data_ptr(), None if rid is None else rid.data_ptr(), stream,
    )
    check(status, "rttg_latency")
    launches += 1
    if want_rid:
        return lat, conn, rid
    return lat, conn


def rttg_latency(pos, speed, accel, t, model_bytes, forced, cfg, *, predict: bool,
                 want_rid: bool = False):
    """Fused geometry chain -> (latency (N,) f32, connected (N,) bool[, rid]).

    ``cfg`` is a ``ScenarioParams``; ``t`` and ``model_bytes`` may be 0-dim
    tensors (they are packed on the device, so no host sync).  CUDA tensors
    go to the kernel, CPU tensors to ``rttg_latency_plain``.
    """
    if pos.is_cuda:
        return _rttg_latency_cuda(pos, speed, accel, t, model_bytes, forced, cfg,
                                  predict, want_rid)
    if pos.device.type != "cpu":
        raise ValueError(f"rttg_latency: unsupported device {pos.device}")
    return rttg_latency_plain(pos, speed, accel, t, model_bytes, forced, cfg,
                              predict, want_rid)
