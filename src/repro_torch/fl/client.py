"""Client-side local training over the cohort (``repro.fl.client``).

The whole cohort trains at once: every parameter leaf carries a leading K
axis (one model per client) and each step backpropagates the sum of the
per-client losses.  The clients' parameters are independent, so each gets
exactly its own gradient, as under ``jax.vmap(jax.grad(...))``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils import prng
from repro_torch.utils.pytree import (flat_spec_of, flatten_to_vector, tree_cast,
                                      unflatten_from_vector)


def make_local_trainer(loss_fn: Callable, lr: float, epochs: int, batch_size: int,
                       mu: float = 0.0, compute_dtype=None) -> Callable:
    """Build the cohort trainer.

    Returned fn: ``(global_params, images (K, n, ...), labels (K, n), key,
    batch_dims=0) -> (updates tree with leading K, update_vecs (K, P))``.
    ``key`` is one cohort key (split K ways) or a ``(K, 2)`` batch of
    per-client keys.  ``global_params``' leaves carry ``batch_dims`` leading
    axes: 0 for one start shared by the cohort, 1 for a start per client
    (``(K, ...)``: the batched grid round trains G lanes' cohorts at once,
    each client from its own lane's model).
    Each client draws ``epochs`` permutations of its ``n`` samples and walks
    them in batches of ``batch_size`` with plain SGD.

    ``mu`` is the FedProx proximal coefficient (Li et al.): each step's
    gradient gains ``mu * (p - p_global)``.  The ``mu == 0`` gate is decided
    here, once, so the default trainer runs no proximal term at all.

    ``compute_dtype`` (a torch dtype, or None = fp32) is the mixed-precision
    lane: each step casts the fp32 parameters to it inside the
    differentiated closure, so the forward pass (and the activations, which
    follow the parameters' dtype) runs in it while autograd of the cast
    hands fp32 gradients back to the fp32 SGD state.  Like ``mu``, the gate
    is decided once: the default trainer casts nothing.
    """
    cast = compute_dtype is not None and compute_dtype != torch.float32

    def train_cohort(global_params: dict, images: torch.Tensor,
                     labels: torch.Tensor, key: torch.Tensor, batch_dims: int = 0):
        K, n = labels.shape
        device = labels.device
        keys = key if key.dim() == 2 else prng.split(key, K)
        spe = max(n // batch_size, 1)
        perm = prng.permutation(prng.split(keys, epochs), n, device)
        idx = perm[..., : spe * batch_size].reshape(K, epochs * spe, batch_size)
        spec = flat_spec_of(global_params, batch_dims)
        start = flatten_to_vector(global_params, batch_dims)  # (P,) or (K, P)
        p = start.expand(K, -1).clone()
        rows = torch.arange(K, device=device)[:, None]
        for s in range(epochs * spe):
            bidx = idx[:, s]
            batch = {"images": images[rows, bidx], "labels": labels[rows, bidx]}
            with torch.enable_grad():
                p = p.detach().requires_grad_(True)
                tree = unflatten_from_vector(p, spec)
                if cast:
                    tree = tree_cast(tree, compute_dtype)
                loss, _ = loss_fn(tree, batch)
                (g,) = torch.autograd.grad(loss.sum(), p)
            p = p.detach()
            if mu:
                g = g + mu * (p - start)
            p = p - lr * g
        vecs = p - start
        return unflatten_from_vector(vecs, spec), vecs

    return train_cohort
