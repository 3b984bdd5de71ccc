"""Digital-twin radio / latency model (``repro.core.network``).

  PL(d)   = 32.4 + 20 log10(f_GHz) + 30 log10(d)
  SNR     = EIRP - PL - noise_floor                        (dB)
  rate    = (B / n_attached) * log2(1 + 10^(SNR/10))
  t_rtt   = 2 bytes/rate + 2 (backhaul + prop) + queue(n_attached) + handover

The pure forms (``snr_from_dist``, ``connected_from_snr``,
``latency_from_geometry``) are the ones the ``rttg_latency`` kernel mirrors
expression for expression; the RTTG-facing wrappers (``snr_db``,
``connectivity``, ``latency_model``) delegate to them, so the fused and the
unfused round compose the same arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.core.rttg import RTTG, congestion_factor
from repro_torch.utils import prng
from repro_torch.utils.elementwise import per_element

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
    snr_lin = per_element(lambda x: torch.pow(10.0, x), snr / 10.0)
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


def snr_db(rttg: RTTG, cfg) -> torch.Tensor:
    return snr_from_dist(rttg.rsu_dist, cfg)


def forced_connections(key, connection_rate: float, shape, device):
    """The forced connection-rate Bernoulli (Tab. I's CR < 1 rows): a bool
    mask drawn from ``key``, or None at CR 1."""
    if connection_rate >= 1.0:
        return None
    if key is None:
        raise ValueError("connectivity: a forced connection rate needs a PRNG key")
    return prng.bernoulli(key, connection_rate, shape, device)


def connectivity(rttg: RTTG, cfg, connection_rate: float = 1.0, key=None) -> torch.Tensor:
    """Bool (N,) connected mask; below CR 1 the forced Bernoulli is drawn
    from ``key`` on ``rsu_dist``'s shape."""
    forced = forced_connections(key, connection_rate, rttg.rsu_dist.shape,
                                rttg.rsu_dist.device)
    return connected_from_snr(snr_db(rttg, cfg), cfg, forced)


def latency_model(rttg: RTTG, model_bytes, cfg) -> torch.Tensor:
    """Round-trip FL communication latency per client, seconds (N,)."""
    return latency_from_geometry(rttg.t, rttg.speed, rttg.rsu_dist, rttg.load, model_bytes,
                                 cfg)
