"""Server-side FedAvg primitives (``repro.fl.server``): the flat layout the
round core carries, and the pytree forms a stage-by-stage caller uses."""
from __future__ import annotations

import torch

from repro_torch.fl.partition import rsu_sample_mass
from repro_torch.utils.pytree import tree_map, tree_weighted_sum


def apply_delta(global_params, delta):
    """``global + delta`` leaf by leaf with fp32 accumulation, dtype-preserving."""
    return tree_map(lambda p, d: (p.to(torch.float32) + d.to(torch.float32)).to(p.dtype),
                    global_params, delta)


def fedavg_aggregate(global_params, updates, weights: torch.Tensor):
    """``global + sum_k w_k update_k`` (weights already normalized).

    ``updates`` is a tree with a leading cohort axis K; ``weights`` (K,).
    """
    return apply_delta(global_params, tree_weighted_sum(updates, weights))


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
