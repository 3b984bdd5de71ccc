"""``repro_torch.sharding``'s rule tables and spec resolution, the LM zoo's
logical axes, and the sharded weight draw, against the reference.

- Every LM arch id, smoke and full, under ``TRAIN_RULES``, ``SERVE_RULES``,
  ``SERVE_FSDP_RULES`` and ``profile_rules(TRAIN_RULES, "dp")``, on the mesh
  shapes (1, 4), (4, 1), (2, 2), (1, 16), (16, 16) over ``("data",
  "model")`` and (2, 16, 16) over ``("pod", "data", "model")`` (shape stubs,
  no devices): the port's ``tree_pspecs`` of its parameter and cache trees
  equal the reference's ``tree_pspecs`` of its ``jax.eval_shape`` trees,
  fallback logs included, in order.
- ``lm_param_axes`` / ``lm_cache_axes`` (and whisper's) equal the
  reference's ``split_params`` axes and cache axes; the port's parameter
  shapes (drawn on the ``meta`` device) equal the reference's.
- A rank's drawn shard (``init_shard``) is bit for bit ``shard_tree`` of
  the whole draw, every leaf of every smoke config on 4 ranks, and for one
  full-width leaf cut on its head axis (its layer axis cut to 1), drawn in
  small chunks so that blocks cross chunk edges; ``prng``'s draws at flat
  indices (``at``) are the flat draw's elements.
- ``launch.steps.input_specs`` / ``cache_specs`` at the four workload shapes
  equal the reference's shapes, dtypes and axes.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_model as jbuild
from repro.sharding import rules as jrules
from repro.sharding import split_params
from repro_torch.configs import LM_ARCHS, get_config, get_smoke_config
from repro_torch.models import build_model, layers
from repro_torch.sharding import rules, shard
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

ARCHS = sorted(LM_ARCHS)
TABLES = {
    "train": (rules.TRAIN_RULES, jrules.TRAIN_RULES),
    "serve": (rules.SERVE_RULES, jrules.SERVE_RULES),
    "serve_fsdp": (rules.SERVE_FSDP_RULES, jrules.SERVE_FSDP_RULES),
    "dp": (rules.profile_rules(rules.TRAIN_RULES, "dp"),
           jrules.profile_rules(jrules.TRAIN_RULES, "dp")),
}
MESHES = {"1x4": {"data": 1, "model": 4}, "4x1": {"data": 4, "model": 1},
          "2x2": {"data": 2, "model": 2}, "1x16": {"data": 1, "model": 16},
          "16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _MeshStub:
    """What ``resolve_pspec`` reads of a mesh: its ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _cfgs(arch, full):
    return (get_config(arch), jget_config(arch)) if full else (get_smoke_config(arch),
                                                               jget_smoke(arch))


@functools.lru_cache(maxsize=None)
def _reference(arch, full):
    """The reference's (param axes, param shapes, cache axes, cache shapes)."""
    cfg = _cfgs(arch, full)[1]
    api = jbuild(cfg)
    values, axes = split_params(jax.eval_shape(lambda: api.init(jax.random.key(0))))
    cache = jax.eval_shape(lambda: api.init_cache(2, 16))
    return axes, values, api.cache_axes(), cache


@functools.lru_cache(maxsize=None)
def _port(arch, full):
    cfg = _cfgs(arch, full)[0]
    api = build_model(cfg)
    return api, shard.param_shapes(api), api.init_cache(2, 16, device="meta")


def _jspecs(axes, shapes, mesh, table):
    log = []
    specs = jrules.tree_pspecs(axes, shapes, _MeshStub(mesh), table, log)
    flat = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    return [tuple(s) for s in flat], log


def _tspecs(axes, shapes, mesh, table):
    log = []
    specs = rules.tree_pspecs(axes, shapes, mesh, table, log)
    out = []
    rules.tree_map_axes(lambda _, s: out.append(s), axes, specs)
    return out, log


def _norm(spec):
    """A reference ``PartitionSpec`` entry tuple with trailing Nones dropped."""
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("full", (False, True), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_fallbacks_match_the_reference(arch, full, table, mesh):
    jaxes, jshapes, jcache_axes, jcache = _reference(arch, full)
    api, tshapes, tcache = _port(arch, full)
    ours, theirs = TABLES[table]
    for what, (taxes, tsh, jax_, jsh) in {
            "params": (api.param_axes(), tshapes, jaxes, jshapes),
            "cache": (api.cache_axes(), tcache, jcache_axes, jcache)}.items():
        want, want_log = _jspecs(jax_, jsh, MESHES[mesh], theirs)
        got, got_log = _tspecs(taxes, tsh, MESHES[mesh], ours)
        assert got == [_norm(s) for s in want], f"{arch} {what} specs"
        assert got_log == want_log, f"{arch} {what} fallback log"


@pytest.mark.parametrize("full", (False, True), ids=("smoke", "full"))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_axes_and_shapes_match_the_reference(arch, full):
    jaxes, jshapes, jcache_axes, jcache = _reference(arch, full)
    api, tshapes, tcache = _port(arch, full)
    assert api.param_axes() == jaxes
    assert api.cache_axes() == jcache_axes
    got = []
    rules.tree_map_axes(lambda _, t: got.append(tuple(t.shape)), api.param_axes(), tshapes)
    assert got == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jshapes)]
    got = []
    rules.tree_map_axes(lambda _, t: got.append(tuple(t.shape)), api.cache_axes(), tcache)
    assert got == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jcache)]


def test_resolve_pspec_falls_back_as_the_reference():
    """mixtral's experts take ``model``, so ``expert_mlp`` falls back; 12 heads
    on 16 ranks replicate; a mesh without the axis replicates silently."""
    mesh = {"data": 1, "model": 4}
    log = []
    spec = rules.resolve_pspec(("layers", "experts", "embed", "expert_mlp"), (2, 8, 64, 96),
                               mesh, rules.SERVE_RULES, log)
    assert spec == (None, "model") and log == [("expert_mlp", (2, 8, 64, 96), 96)]
    log = []
    assert rules.resolve_pspec(("heads",), (12,), {"model": 16}, rules.TRAIN_RULES, log) == ()
    assert log == [("heads", (12,), 12)]
    assert rules.resolve_pspec(("batch",), (8,), {"pod": 2, "data": 4}, rules.TRAIN_RULES) \
        == (("pod", "data"),)
    assert rules.resolve_pspec(("batch",), (6,), {"pod": 2, "data": 4}, rules.TRAIN_RULES) \
        == ("pod",)
    with pytest.raises(ValueError, match="profile"):
        rules.profile_rules(rules.TRAIN_RULES, "pp")


def _ranks(mesh, table=rules.SERVE_RULES):
    n = int(np.prod(list(mesh.values())))
    return [shard.Rank(i, n, mesh, shard.coords_of(i, mesh), table) for i in range(n)]


def _assert_trees_equal(got, want, axes, what):
    rules.tree_map_axes(lambda a, g, w: _equal(g, w, f"{what} {a}"), axes, got, want)


def _equal(g, w, what):
    assert g.dtype == w.dtype and g.shape == w.shape, what
    assert torch.equal(g, w), what


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_draw_is_the_whole_draw_cut(arch):
    """Each of 4 ranks' ``init_shard`` == ``shard_tree`` of the whole draw, bit
    for bit, under ``SERVE_RULES`` on a (1, 4) mesh and ``TRAIN_RULES`` on a
    (2, 2) one; the 4 ranks' blocks tile every leaf."""
    api = build_model(get_smoke_config(arch))
    key = prng.fold_in_str(prng.key(0), "init")
    whole = api.init(key, "cpu")
    for mesh, table in (({"data": 1, "model": 4}, rules.SERVE_RULES),
                        ({"data": 2, "model": 2}, rules.TRAIN_RULES)):
        count = rules.tree_map_axes(lambda _, t: torch.zeros(t.shape, dtype=torch.int32),
                                    api.param_axes(), whole)
        for rank in _ranks(mesh, table):
            got = shard.init_shard(api, key, rank, "cpu")
            want = shard.shard_tree(whole, api.param_axes(), mesh, table, rank.coords)
            _assert_trees_equal(got, want, api.param_axes(), f"{arch} rank {rank.index}")
            blocks = shard.tree_blocks(api.param_axes(), whole, mesh, table, rank.coords)
            rules.tree_map_axes(lambda _, c, b: c[b].add_(1), api.param_axes(), count, blocks)
        # a leaf replicated over an axis is held once a rank of that axis
        rules.tree_map_axes(lambda a, c: _covered(c, f"{arch} {a}"), api.param_axes(), count)


def _covered(count, what):
    assert bool((count == count.flatten()[0]).all()) and int(count.flatten()[0]) >= 1, what


def test_shard_draw_of_a_full_width_leaf_across_chunks(monkeypatch):
    """mistral-nemo-12b's full-width ``wk`` (its 40 layers cut to 1: (1, 5120, 8,
    128)), kv heads cut over 4 ranks (dim 2), drawn 40,000 elements a chunk:
    each rank's block is the whole draw's, bit for bit, in bf16 and fp32."""
    monkeypatch.setattr(layers, "INIT_CHUNK", 40_000)
    cfg = get_config("mistral-nemo-12b")
    shape = (1, cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim)
    key = prng.key(5)
    mesh = {"data": 1, "model": 4}
    spec = rules.resolve_pspec(("layers", "embed", "kv_heads", "head_dim"), shape, mesh,
                               rules.SERVE_RULES)
    assert spec == (None, None, "model")
    for dtype in (torch.float32, torch.bfloat16):
        whole = layers.dense_init(key, shape, cfg.d_model, dtype)
        for r in range(4):
            block = shard.leaf_block(spec, shape, mesh, {"data": 0, "model": r})
            got = layers.dense_init(key, shape, cfg.d_model, dtype, block=block)
            _equal(got, whole[block], f"rank {r} {dtype}")


def test_draws_at_indices_are_the_flat_draw():
    k = prng.key(11)
    at = torch.tensor([[5, 0], [77, 1 << 33]])
    flat = prng.bits(k, (78,))
    got = prng.bits(k, at=at)
    assert got.shape == (2, 2)
    assert got[:, :1].flatten().tolist() == [int(flat[5]), int(flat[77])]
    assert int(got[1, 1]) == int(prng.bits(k, (1,), start=1 << 33)[0])
    for f in (lambda **kw: prng.uniform(k, **kw), lambda **kw: prng.normal(k, **kw),
              lambda **kw: prng.truncated_normal(k, -2.0, 2.0, **kw)):
        assert torch.equal(f(at=torch.arange(10, 20)), f(shape=(30,))[10:20])


def test_leaf_block_cuts_multi_axis_dims_major_first():
    mesh = {"pod": 2, "data": 2, "model": 2}
    coords = {"pod": 1, "data": 0, "model": 1}
    assert shard.coords_of(5, mesh) == coords
    assert shard.leaf_block((("pod", "data"), "model"), (8, 6), mesh, coords) == (
        slice(4, 6), slice(3, 6))
    assert shard.leaf_block((), (3,), mesh, coords) == (slice(0, 3),)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_the_reference(arch, shape):
    """``launch.steps.input_specs`` / ``cache_specs`` at each assigned workload
    shape (smoke configs): shapes, dtypes and logical axes the reference's."""
    from repro.config import shape_by_name
    from repro.launch import steps as jsteps
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import steps

    tcfg, jcfg = _cfgs(arch, False)
    jshape, tshape = shape_by_name(shape), INPUT_SHAPES[shape]
    assert tshape == type(tshape)(**jshape.__dict__)
    for (tspecs, taxes), (jspecs, jaxes) in (
            (steps.input_specs(tcfg, tshape), jsteps.input_specs(jcfg, jshape)),
            (steps.cache_specs(build_model(tcfg), tshape),
             jsteps.cache_specs(jbuild(jcfg), jshape))):
        assert taxes == jaxes
        got = []
        rules.tree_map_axes(lambda _, t: got.append((tuple(t.shape), str(t.dtype).split(".")[-1])),
                            taxes, tspecs)
        want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(jspecs)]
        assert got == want
