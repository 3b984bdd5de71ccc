"""SGD, momentum and AdamW over parameter trees (``repro.optim.optimizers``).

Each optimizer is an ``(init, update)`` pair over a tree of tensors (nested
dicts and lists, as the LM zoo's parameters).  The moments are fp32 whatever
the parameter dtype (bf16 params, fp32 optimizer state); every update runs
in fp32 and is cast back to the parameter's dtype.  ``update`` returns new
trees and leaves its inputs as they are.  The step count and the clip scale
stay on the device: nothing here reads a value back to the host.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.utils.pytree import tree_global_norm, tree_leaves, tree_map

PyTree = Any
_F32 = torch.float32


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: PyTree  # first moment (or momentum buffer); 0-dim zeros per leaf for sgd
    nu: PyTree  # second moment; 0-dim zeros per leaf where unused


class Optimizer(NamedTuple):
    init: Callable[[PyTree], OptState]
    update: Callable[[PyTree, OptState, PyTree], Tuple[PyTree, OptState]]


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """Every gradient times ``min(1, max_norm / (norm + 1e-12))`` in fp32,
    cast back to the gradient's dtype."""
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.to(_F32) * scale).to(g.dtype), grads)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    return torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)


def _zeros_f32(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params)


def _scalar_zeros(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros((), dtype=_F32, device=p.device), params)


def sgd(lr: float) -> Optimizer:
    def init(params):
        z = _scalar_zeros(params)
        return OptState(_step0(params), z, z)

    def update(grads, state, params):
        new = tree_map(lambda p, g: (p.to(_F32) - lr * g.to(_F32)).to(p.dtype), params, grads)
        return new, OptState(state.step + 1, state.mu, state.nu)

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return OptState(_step0(params), _zeros_f32(params), _scalar_zeros(params))

    def update(grads, state, params):
        mu = tree_map(lambda m, g: beta * m + g.to(_F32), state.mu, grads)
        new = tree_map(lambda p, m: (p.to(_F32) - lr * m).to(p.dtype), params, mu)
        return new, OptState(state.step + 1, mu, state.nu)

    return Optimizer(init, update)


def adamw(lr: float, beta1: float = 0.9, beta2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return OptState(_step0(params), _zeros_f32(params), _zeros_f32(params))

    def update(grads, state, params):
        step = state.step + 1
        t = step.to(_F32)
        # beta ** t and the bias corrections in fp32, as the reference's weakly
        # typed Python scalars against an fp32 step give them
        bc1 = 1.0 - torch.pow(torch.tensor(beta1, dtype=_F32, device=t.device), t)
        bc2 = 1.0 - torch.pow(torch.tensor(beta2, dtype=_F32, device=t.device), t)
        mu = tree_map(lambda m, g: beta1 * m + (1 - beta1) * g.to(_F32), state.mu, grads)
        nu = tree_map(lambda v, g: beta2 * v + (1 - beta2) * torch.square(g.to(_F32)),
                      state.nu, grads)

        def _apply(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.to(_F32)
            return (p.to(_F32) - lr * upd).to(p.dtype)

        return tree_map(_apply, params, mu, nu), OptState(step, mu, nu)

    return Optimizer(init, update)


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    if cfg.optimizer == "adamw":
        return adamw(cfg.learning_rate, cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    if cfg.optimizer == "momentum":
        return momentum(cfg.learning_rate, cfg.beta1)
    if cfg.optimizer == "sgd":
        return sgd(cfg.learning_rate)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
