"""Stage 3: client grouping by update sketches (``repro.core.clustering``).

Each update is folded against a seeded Rademacher sign vector into a
``sketch_dim`` count-sketch, unit-normalized, and clustered with cosine
k-means (farthest-point init, Lloyd iterations).
"""
from __future__ import annotations

import torch

from repro_torch.utils import prng


def sketch_sign_vector(key: torch.Tensor, dim: int, sketch_dim: int,
                       device) -> torch.Tensor:
    """Seeded +-1 signs for ``dim``-long updates, padded to a sketch multiple."""
    pad = (-dim) % sketch_dim
    sign_bits = prng.bernoulli(prng.fold_in_str(key, "sketch-sign"), 0.5,
                               (dim + pad,), device)
    return torch.where(sign_bits, 1.0, -1.0).to(torch.float32)


def apply_sketch(update_vecs: torch.Tensor, sign: torch.Tensor,
                 sketch_dim: int) -> torch.Tensor:
    """Fold ``(..., P)`` updates against the signs -> unit ``(..., sketch_dim)``."""
    D = update_vecs.shape[-1]
    pad = (-D) % sketch_dim
    x = torch.nn.functional.pad(update_vecs.to(torch.float32), (0, pad)) * sign
    acc = x.reshape(update_vecs.shape[:-1] + (-1, sketch_dim)).sum(dim=-2)
    norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp_min(norm, 1e-12)


def kmeans_cluster(sketches: torch.Tensor, key: torch.Tensor, k: int,
                   iters: int = 25):
    """Cosine k-means on unit sketches -> (labels (N,) int64, centroids (k, D)).

    Deterministic given ``key``; farthest-point init; empty clusters
    re-seed at the globally worst-fit point.  argmin / argmax return the
    first index on ties, as in JAX.
    """
    x = sketches.to(torch.float32)
    x = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)
    N, D = x.shape
    device = x.device
    first = prng.randint(prng.fold_in_str(key, "kmeans-init"), (), 0, N, device)
    cents = torch.zeros((k, D), dtype=torch.float32, device=device)
    cents[0] = x[first]
    cols = torch.arange(k, device=device)[None, :]
    for n_done in range(1, k):
        sim = x @ cents.T
        sim = torch.where(cols < n_done, sim, -torch.inf)
        best = sim.max(dim=1).values  # most-similar chosen centroid
        cents[n_done] = x[torch.argmin(best)]  # farthest point
    for _ in range(iters):
        sim = x @ cents.T
        labels = torch.argmax(sim, dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)
        sums = onehot.T @ x
        counts = onehot.sum(dim=0)
        new = sums / torch.clamp_min(counts[:, None], 1e-9)
        worst = torch.argmin(sim.max(dim=1).values)
        new = torch.where(counts[:, None] > 0, new, x[worst][None, :])
        cents = new / torch.clamp_min(torch.linalg.vector_norm(new, dim=1, keepdim=True), 1e-12)
    labels = torch.argmax(x @ cents.T, dim=1)
    return labels, cents
