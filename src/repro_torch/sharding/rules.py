"""Logical axis names -> mesh axes, with the reference's divisibility fallback
(``repro.sharding.rules``), in plain Python.

Every parameter and cache dimension carries a *logical* axis name ("embed",
"heads", "mlp", ...); ``models.transformer.lm_param_axes`` /
``lm_cache_axes`` give them for every leaf.  A rule table maps a logical
name to the mesh axes it may shard over.  ``resolve_pspec`` applies a table
to one shape on one mesh and falls back to replication whenever

  - the mesh has no axis of that name (e.g. "pod" on a ``("data", "model")``
    mesh),
  - the dimension is not divisible by the product of the mapped axis sizes
    (the axes are shrunk from the right first),
  - the mesh axis was already taken by an earlier dimension of the same
    tensor (mixtral's ``expert_mlp`` once ``experts`` holds ``model``).

A spec is a plain tuple, one entry a dimension: a mesh axis name, a tuple
of names, or None (replicated), trailing Nones dropped, as the reference's
``PartitionSpec`` holds them.  A mesh is anything with a ``shape`` mapping
(``launch.mesh.LMMesh``) or the mapping itself (``{"data": 1, "model":
4}``).  The port has no JAX shardings, so ``Param``, ``split_params`` and
``tree_shardings`` have no counterpart: the axes come from
``lm_param_axes``, and ``sharding.shard`` cuts and draws the blocks.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

# Logical name -> tuple of mesh axis names (tried in order, all-or-prefix).
# ``None`` means "always replicate".
TRAIN_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "client": ("pod", "data"),  # FL cohort axis
    "grid": ("pod", "data"),  # FL experiment-grid axis
    "data_rows": ("pod", "data"),  # the engine's shard-local RoundData rows
    "seq": None,
    "embed": ("data",),  # ZeRO-3 / FSDP shard of params over the data axis
    "embed_act": None,  # activations keep embed replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    # per-expert ffn dim: takes the model axis whenever "experts" could not
    "expert_mlp": ("model",),
    "expert_cap": ("data",),  # MoE dispatch buffers: capacity over data
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "ssm_state": None,
    "conv": None,
    "kv_seq": None,
    "layers": None,  # the stacked layer axis
    "stack": None,
    "classes": None,
    "hw": None,  # image spatial dims (CNN models)
}

# Serving keeps full parameters resident: params replicate over "data", KV
# caches shard batch over data and heads over model.
SERVE_RULES: Dict[str, Optional[Tuple[str, ...]]] = dict(TRAIN_RULES, embed=None)

# 70B+ class: keep the ZeRO-3 embed shard at serving.
SERVE_FSDP_RULES: Dict[str, Optional[Tuple[str, ...]]] = dict(TRAIN_RULES)


def profile_rules(base: Dict[str, Optional[Tuple[str, ...]]],
                  profile: str) -> Dict[str, Optional[Tuple[str, ...]]]:
    """A per-arch sharding profile applied to a rule table: "tp" is the table
    as it is; "dp" turns the model axis into more data parallelism (batch
    over every axis, parameters ZeRO-3-sharded over (data, model) where the
    table shards ``embed``, no tensor parallelism)."""
    if profile == "tp":
        return base
    if profile != "dp":
        raise ValueError(f"unknown sharding profile {profile!r}")
    out = dict(base)
    out.update(
        batch=("pod", "data", "model"),
        client=("pod", "data", "model"),
        embed=("data", "model") if base.get("embed") else None,
        heads=None,
        kv_heads=None,
        head_dim=None,
        mlp=("data", "model") if base.get("embed") else None,
        vocab=None,
        ssm_heads=None,
        ssm_inner=None,
        expert_cap=None,
    )
    return out


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a mesh (anything with a ``shape`` mapping) or of the
    mapping itself."""
    return dict(getattr(mesh, "shape", mesh))


def resolve_pspec(logical_axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                  rules: Mapping[str, Optional[Tuple[str, ...]]],
                  fallback_log: Optional[list] = None) -> tuple:
    """The spec of one tensor: its logical axes resolved on ``mesh`` under
    ``rules``.  A dimension that falls back to replication, though its name
    maps to some axes, appends ``(name, shape, dim)`` to ``fallback_log``."""
    used: set = set()
    spec: list = []
    sizes = mesh_sizes(mesh)
    for dim, name in zip(shape, logical_axes):
        if name is None:
            spec.append(None)
            continue
        axes = rules.get(name)
        if axes is None:
            spec.append(None)
            continue
        # keep only axes present in this mesh and not yet used by this tensor
        cand = tuple(a for a in axes if a in sizes and a not in used)
        # shrink from the right until the dimension divides evenly
        while cand:
            prod = 1
            for a in cand:
                prod *= sizes[a]
            if prod > 1 and dim % prod == 0:
                break
            cand = cand[:-1]
        if cand:
            prod = 1
            for a in cand:
                prod *= sizes[a]
            if prod == 1:
                cand = ()
        if cand:
            used.update(cand)
            spec.append(cand if len(cand) > 1 else cand[0])
        else:
            if fallback_log is not None and axes:
                fallback_log.append((name, tuple(shape), dim))
            spec.append(None)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def is_axes_leaf(x) -> bool:
    """An axes annotation: a plain tuple of axis names / None (``()`` too)."""
    return (isinstance(x, tuple) and not hasattr(x, "_fields")
            and all(e is None or isinstance(e, str) for e in x))


def leaf_shape(x) -> Tuple[int, ...]:
    """A shapes-tree leaf's shape: a tensor (or anything with ``shape``) or a
    tuple of ints."""
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (dicts and lists, axes tuples as
    leaves) and trees of the same structure; dict keys in sorted order, as
    ``jax.tree_util`` visits them (so a fallback log comes in its order)."""
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in sorted(axes_tree)}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_map_axes(fn, v, *(t[i] for t in trees))
                               for i, v in enumerate(axes_tree))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def tree_pspecs(axes_tree, shapes_tree, mesh, rules, fallback_log=None):
    """(axes, shapes) trees -> the tree of specs, leaf by leaf in tree order."""
    return tree_map_axes(
        lambda axes, shaped: resolve_pspec(axes, leaf_shape(shaped), mesh, rules, fallback_log),
        axes_tree, shapes_tree)
