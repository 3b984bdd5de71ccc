"""Server-side FedAvg primitives on the flat layout (``repro.fl.server``)."""
from __future__ import annotations

import torch

from repro_torch.fl.partition import rsu_sample_mass


def normalized_weights(mask_selected: torch.Tensor, n_samples: torch.Tensor) -> torch.Tensor:
    """FedAvg weights proportional to sample counts, masked + normalized."""
    w = mask_selected.to(torch.float32) * n_samples.to(torch.float32)
    return w / torch.clamp_min(w.sum(), 1e-9)


def rsu_normalized_weights(mask_selected, n_samples, rid, live, n_rsu: int, *,
                           mass_norm: bool = True):
    """Two-tier FedAvg weights -> ``(w (K,), mass (R,), total ())``.

    The unnormalized weights are ``normalized_weights``' expression; the
    normalizer is the sum of LIVE RSU masses, so a dark RSU's partial
    drops.  With every RSU live and integer-valued ``n_samples`` this is
    ``normalized_weights`` bit for bit.  ``mass_norm=False`` normalizes by
    the flat sum instead (the stale lane's discounted, non-integer
    weights).  The caller folds RSU liveness into ``mask_selected``.
    """
    w = mask_selected.to(torch.float32) * n_samples.to(torch.float32)
    mass = rsu_sample_mass(w, rid, n_rsu)
    total = torch.where(live, mass, 0.0).sum() if mass_norm else w.sum()
    return w / torch.clamp_min(total, 1e-9), mass, total


def apply_delta_flat(params_vec: torch.Tensor, delta_vec: torch.Tensor) -> torch.Tensor:
    """``params + delta`` with fp32 accumulation, in the master dtype."""
    acc = params_vec.to(torch.float32) + delta_vec.to(torch.float32)
    return acc.to(params_vec.dtype)
