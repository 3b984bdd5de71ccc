"""Flat-vector layout of a parameter tree (``repro.utils.pytree``).

The round core carries the global model as one flat fp32 ``(P,)`` vector.
Its layout is JAX's: leaves in sorted-key order, list items in index
order (``fc1.b``, ``fc1.w``, ``fc2.b``, ``fc2.w`` for the MLP;
``convs[0].b``, ``convs[0].w``, ``convs[1].b``, ... before them for a CNN),
each raveled row-major, dense weights stored ``(in, out)``, conv kernels
HWIO.  The update vectors, the sketches (indexed by position against
``sketch_sign``) and the kernel operands all depend on it.

A tree here is nested ``dict`` and ``list`` nodes over tensors; a spec is
the list of ``(path, shape)`` pairs in flat order, a path element a ``str``
(a dict key) or an ``int`` (a list index).  Leaves may carry leading batch
dimensions (the cohort axis) in front of their spec shape.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple, Union

import torch

Spec = List[Tuple[Tuple[Union[str, int], ...], Tuple[int, ...]]]


def _leaves(tree, prefix=()):
    items = (((name, tree[name]) for name in sorted(tree)) if isinstance(tree, dict)
             else enumerate(tree))
    for name, value in items:
        if isinstance(value, (dict, list, tuple)):
            yield from _leaves(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def flat_spec_of(tree, batch_dims: int = 0) -> Spec:
    """The ``(path, shape)`` spec of a tree, dropping ``batch_dims`` leading axes."""
    return [(path, tuple(x.shape[batch_dims:])) for path, x in _leaves(tree)]


def flat_size_of(spec: Spec) -> int:
    return sum(math.prod(shape) for _, shape in spec)


def flatten_to_vector(tree, batch_dims: int = 0) -> torch.Tensor:
    """Concatenate the leaves in flat order -> ``batch + (P,)`` fp32."""
    parts = []
    for _, x in _leaves(tree):
        batch = x.shape[:batch_dims]
        parts.append(x.to(torch.float32).reshape(batch + (-1,)))
    return torch.cat(parts, dim=-1)


def _lists(node):
    """Dicts keyed by list indices (``int``) back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(isinstance(k, int) for k in node):
        return [_lists(node[i]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}


def unflatten_from_vector(vec: torch.Tensor, spec: Spec) -> Dict:
    """Invert ``flatten_to_vector``; leading dims of ``vec`` stay batch dims."""
    batch = vec.shape[:-1]
    tree: Dict = {}
    off = 0
    for path, shape in spec:
        n = math.prod(shape)
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = vec[..., off:off + n].reshape(batch + tuple(shape))
        off += n
    return _lists(tree)


def tree_bytes(spec: Spec, itemsize: int = 4) -> int:
    """Storage bytes of a spec's leaves (fp32 by default)."""
    return flat_size_of(spec) * itemsize


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_cast(tree, dtype):
    """Every leaf of ``tree`` cast to ``dtype``."""
    return tree_map(lambda x: x.to(dtype), tree)


def tree_weighted_sum(trees, weights: torch.Tensor):
    """Weighted sum over the leading axis of a stacked tree.

    ``trees`` has leaves ``(K, ...)`` (one slice per client), ``weights``
    is ``(K,)``; each leaf sums in fp32 and returns in its own dtype.  The
    pytree FedAvg contraction (``fedavg_reduce`` is its flat form).
    """
    def _ws(x):
        w = weights.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
        return (x.to(torch.float32) * w).sum(dim=0).to(x.dtype)

    return tree_map(_ws, trees)
