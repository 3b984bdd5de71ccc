"""Server-side FedAvg primitives on the flat layout (``repro.fl.server``)."""
from __future__ import annotations

import torch


def normalized_weights(mask_selected: torch.Tensor, n_samples: torch.Tensor) -> torch.Tensor:
    """FedAvg weights proportional to sample counts, masked + normalized."""
    w = mask_selected.to(torch.float32) * n_samples.to(torch.float32)
    return w / torch.clamp_min(w.sum(), 1e-9)


def apply_delta_flat(params_vec: torch.Tensor, delta_vec: torch.Tensor) -> torch.Tensor:
    """``params + delta`` with fp32 accumulation, in the master dtype."""
    acc = params_vec.to(torch.float32) + delta_vec.to(torch.float32)
    return acc.to(params_vec.dtype)
