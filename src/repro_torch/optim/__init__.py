"""Optimizers of the port (``repro.optim``): SGD, momentum, AdamW over tensor trees."""
from repro_torch.optim.optimizers import (OptState, Optimizer, adamw, clip_by_global_norm,
                                          make_optimizer, momentum, sgd)

__all__ = ["OptState", "Optimizer", "make_optimizer", "sgd", "momentum", "adamw",
           "clip_by_global_norm"]
