"""Step functions of the LM trainer and server (``repro.launch.steps``).

``make_train_step(api, tcfg)`` -> ``(train_step, opt)``:
``train_step(TrainState, batch) -> (TrainState, metrics)`` runs the loss and
its gradient by autograd, clips the gradient by its global norm, then takes
the optimizer's step, as the reference's jitted step does.

- With one microbatch the gradient comes in the parameters' dtype (bf16 at
  full width).
- With ``m = cfg.train_microbatches > 1`` the batch is cut into m
  consecutive slices of ``B // m`` rows.  The gradients sum in fp32 and are
  divided by m, so they stay fp32; loss and metrics are the microbatches'
  means.  As in the reference, the last ``B % m`` rows take no part.  A
  batch of fewer than m rows raises ``ValueError``.

Autograd runs on fresh leaves that share the parameters' storage, so the
state's tensors never carry grad.  ``make_prefill_step`` and
``make_decode_step`` run with grad off.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.optim import OptState, clip_by_global_norm, make_optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any
    opt_state: OptState


def value_and_grad(loss_fn, params, batch):
    """(loss, metrics, grads) of ``loss_fn(params, batch)``, the grads a tree
    like ``params`` in their dtypes; a leaf the loss does not reach gets zeros."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch)
        loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None else torch.zeros_like(p), leaves)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(api, tcfg: TrainConfig):
    opt = make_optimizer(tcfg)
    m = max(api.cfg.train_microbatches, 1)

    def train_step(state: TrainState, batch):
        if m == 1:
            loss, metrics, grads = value_and_grad(api.loss, state.params, batch)
        else:
            B = tree_leaves(batch)[0].shape[0]
            mb = B // m
            if mb == 0:
                raise ValueError(f"{api.cfg.name}: a batch of {B} rows cannot be cut into its "
                                 f"{m} microbatches (train_microbatches); give at least {m} rows")
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            lsum = None
            mets = []
            for i in range(m):
                sl = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, met, g = value_and_grad(api.loss, state.params, sl)
                tree_map(lambda s, x: s.add_(x.to(torch.float32)), grads, g)
                lsum = l if lsum is None else lsum + l
                mets.append(met)
            grads = tree_map(lambda g: g / m, grads)
            loss = lsum / m
            metrics = {k: torch.stack([mt[k] for mt in mets]).mean(dim=0) for k in mets[0]}
        grads = clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = opt.update(grads, state.opt_state, state.params)
        return TrainState(params, opt_state), dict(metrics, loss=loss)

    return train_step, opt


def make_prefill_step(api):
    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(params, batch)

    return prefill_step


def make_decode_step(api):
    @torch.no_grad()
    def decode_step(params, cache, tokens):
        return api.decode_step(params, cache, tokens)

    return decode_step
