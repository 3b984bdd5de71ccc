"""Digital-twin radio / latency model (``repro.core.network``).

  PL(d)   = 32.4 + 20 log10(f_GHz) + 30 log10(d)
  SNR     = EIRP - PL - noise_floor                        (dB)
  rate    = (B / n_attached) * log2(1 + 10^(SNR/10))
  t_rtt   = 2 bytes/rate + 2 (backhaul + prop) + queue(n_attached) + handover

The pure forms the ``rttg_latency`` kernel mirrors expression for expression.
"""
from __future__ import annotations

import torch

from repro_torch.core.rttg import congestion_factor

_C = 299_792_458.0


def snr_from_dist(rsu_dist: torch.Tensor, cfg) -> torch.Tensor:
    """SNR (dB) per client from the 3D distance to the attached RSU."""
    d = torch.clamp_min(rsu_dist, 1.0)
    pl = 32.4 + 20.0 * torch.log10(cfg.carrier_ghz) + 30.0 * torch.log10(d)
    return cfg.eirp_dbm - pl - cfg.noise_dbm


def connected_from_snr(snr: torch.Tensor, cfg, forced=None) -> torch.Tensor:
    """Bool connected mask: SNR above threshold and the forced-CR draw."""
    ok = snr >= cfg.snr_min_db
    if forced is not None:
        ok = ok & forced
    return ok


def latency_from_geometry(t, speed, rsu_dist, rsu_load, model_bytes, cfg):
    """Round-trip FL latency (s) from per-client attachment geometry."""
    snr = snr_from_dist(rsu_dist, cfg)
    snr_lin = torch.pow(10.0, snr / 10.0)
    load = rsu_load * congestion_factor(t, cfg)
    rate = cfg.bandwidth_hz / torch.clamp_min(load, 1.0) * torch.log2(1.0 + snr_lin)
    rate = torch.clamp_min(rate, 1e4)  # 10 kb/s floor off coverage
    mb = torch.as_tensor(model_bytes, dtype=torch.float32, device=speed.device)
    payload_bits = 8.0 * (mb + cfg.overhead_bytes)
    t_air = 2.0 * payload_bits / rate
    t_prop = 2.0 * rsu_dist / _C + 2.0 * cfg.backhaul_s
    t_queue = cfg.queue_s_per_vehicle * load
    edge = rsu_dist / (0.5 * cfg.rsu_spacing_m)  # ~1 at the cell edge
    t_handover = 0.2 * torch.clamp(edge - 0.7, 0.0, 1.0) * speed / cfg.mean_speed_mps
    return t_air + t_prop + t_queue + t_handover
