"""Stage 4: client selection strategies (``repro.core.selection``).

All five share one signature and return a bool participation mask (N,):

  greedy     : every connected client.
  gossip     : uniform random ``n_select`` among connected.
  data       : cluster coverage, round-robin random member per cluster.
  network    : ``n_select`` lowest predicted latency among connected.
  contextual : Fast-gamma, per cluster the gamma fraction of connected
               members with the lowest predicted latency (>= 1 each).

Ties break toward the lower client index everywhere, as ``lax.top_k`` and
``jnp.lexsort`` break them in the JAX package.  Each strategy also elects G
lanes at once: ``(G, N)`` inputs and ``(G, 2)`` keys give a ``(G, N)`` mask,
each lane's row its one-lane election (every sort, gather and count runs
along the last axis).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.utils import prng

_BIG = 1e30


def _top_k_mask(score: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the k smallest scores (lower index first on ties); +_BIG never."""
    N = score.shape[-1]
    k = max(min(k, N), 0)
    mask = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    if k == 0:
        return mask
    idx = torch.sort(score, dim=-1, stable=True).indices[..., :k]
    return mask.scatter_(-1, idx, True) & (score < _BIG)


def _where_connected(connected, score):
    return torch.where(connected, score, torch.full_like(score, _BIG))


def select_greedy(key, connected, latency_pred, clusters, n_select, gamma):
    return connected


def select_gossip(key, connected, latency_pred, clusters, n_select, gamma):
    noise = prng.uniform(key, connected.shape[-1:], device=connected.device)
    return _top_k_mask(_where_connected(connected, noise), n_select)


def select_network(key, connected, latency_pred, clusters, n_select, gamma):
    return _top_k_mask(_where_connected(connected, latency_pred), n_select)


def _segments(sorted_clusters: torch.Tensor) -> torch.Tensor:
    """Bool: where a new cluster starts along the last axis of sorted labels."""
    newseg = torch.ones(sorted_clusters.shape, dtype=torch.bool, device=sorted_clusters.device)
    newseg[..., 1:] = sorted_clusters[..., 1:] != sorted_clusters[..., :-1]
    return newseg


def _per_cluster_rank(score: torch.Tensor, clusters: torch.Tensor) -> torch.Tensor:
    """Rank of each client within its cluster by ascending score (0 = best).

    ``jnp.lexsort((idx, score, clusters))`` built from stable sorts, last key
    first; the running segment start is a cumulative max.
    """
    N = score.shape[-1]
    idx = torch.arange(N, device=score.device)
    order = torch.sort(score, dim=-1, stable=True).indices
    order = torch.gather(order, -1, torch.sort(torch.gather(clusters, -1, order), dim=-1,
                                               stable=True).indices)
    newseg = _segments(torch.gather(clusters, -1, order))
    start = torch.cummax(torch.where(newseg, idx, 0), dim=-1).values
    return torch.empty_like(order).scatter_(-1, order, idx - start)


def _cluster_sizes(clusters: torch.Tensor, connected: torch.Tensor) -> torch.Tensor:
    """(..., N) connected-member count of each client's cluster (integer-exact)."""
    order = torch.sort(clusters, dim=-1, stable=True).indices
    seg = torch.cumsum(_segments(torch.gather(clusters, -1, order)).to(torch.int64), dim=-1) - 1
    cnt = torch.zeros(clusters.shape, dtype=torch.int64, device=clusters.device).scatter_add_(
        -1, seg, torch.gather(connected, -1, order).to(torch.int64))  # compact ids < N
    return torch.empty_like(order).scatter_(-1, order, torch.gather(cnt, -1, seg))


def select_data(key, connected, latency_pred, clusters, n_select, gamma):
    """Cluster coverage with random within-cluster choice."""
    noise = prng.uniform(key, connected.shape[-1:], device=connected.device)
    score = _where_connected(connected, noise)
    rank = _per_cluster_rank(score, clusters)
    order_score = rank.to(torch.float32) * 1e6 + score
    return _top_k_mask(_where_connected(connected, order_score), n_select)


def select_contextual(key, connected, latency_pred, clusters, n_select, gamma):
    """Fast-gamma: per cluster, the gamma fraction lowest-latency clients."""
    score = _where_connected(connected, latency_pred)
    rank = _per_cluster_rank(score, clusters)
    csize = _cluster_sizes(clusters, connected)
    quota = torch.clamp_min(torch.ceil(gamma * csize.to(torch.float32)), 1.0)
    mask = connected & (rank < quota)
    order_score = rank.to(torch.float32) * 1e6 + torch.where(mask, score, _BIG)
    return _top_k_mask(torch.where(mask, order_score, _BIG), n_select)


STRATEGIES: Dict[str, Callable] = {
    "greedy": select_greedy,
    "gossip": select_gossip,
    "data": select_data,
    "network": select_network,
    "contextual": select_contextual,
}


def select_clients(strategy: str, key, connected, latency_pred, clusters, n_select: int,
                   gamma: float) -> torch.Tensor:
    if strategy not in STRATEGIES:
        raise KeyError(f"unknown strategy {strategy!r}; known: {sorted(STRATEGIES)}")
    return STRATEGIES[strategy](key, connected, latency_pred, clusters, n_select, gamma)
