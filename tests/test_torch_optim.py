"""The port's optimizers, tree helpers and checkpoints against the JAX package.

``repro_torch.optim`` (SGD, momentum, AdamW, ``clip_by_global_norm``),
``repro_torch.utils.pytree``'s tree arithmetic and ``TrainConfig`` against
``repro.optim`` / ``repro.utils`` / ``repro.config``, on trees of nested
dicts and lists drawn from a numpy seed, in fp32 and bf16.  Tolerances: fp32
params, moments and norms within rtol 2e-6 (XLA's and PyTorch's ``pow`` and
reductions may round an ulp apart; the update is ``lr`` times that);
bf16 params within one bf16 ulp (a cast at a rounding boundary), step
counts and 0-dim moment shapes exactly.

``repro_torch.checkpoint.CheckpointManager`` against
``repro.checkpoint.CheckpointManager``: the member names letter for letter,
fp32 files restoring both ways exactly, bf16 members byte for byte, the
port's bf16 round trip exactly, ``keep`` garbage collection, and a missing
leaf or a shape mismatch raising.  The reference writes a bf16 leaf as raw
``'<V2'`` records that its own ``restore`` cannot cast
(``ValueError: No cast function available``); the port reads them back.
"""
import dataclasses
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.checkpoint import CheckpointManager as JCkpt
from repro.config import TrainConfig as JTrainConfig
from repro.utils import pytree as jtree
from repro_torch import optim as topt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import TrainConfig
from repro_torch.utils import pytree as ttree
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

FP32_RTOL = 2e-6
BF16_ULP = 2.0 ** -8  # one bf16 ulp relative to the value


def _np_tree(seed, scale=1.0):
    """A tree of nested dicts and lists of float32 numpy leaves (keys out of
    sorted order, so insertion order and JAX's flat order differ)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return np.asarray(scale * rng.standard_normal(shape), dtype=np.float32)

    return {"w": a(5, 7), "blocks": [{"z": a(3), "attn": {"wq": a(4, 2, 3)}}, {"z": a(3),
            "attn": {"wq": a(4, 2, 3)}}], "b": a(7), "s": a()}


def _jax(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(dtype), tree)


def _torch(tree, dtype):
    return ttree.tree_map(lambda x: torch.from_numpy(x).to(dtype), tree)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat_np(tree):
    if isinstance(tree, dict) or isinstance(tree, list):
        return [_f32(x) for x in ttree.tree_leaves(tree)]
    return [_f32(x) for x in jax.tree_util.tree_leaves(tree)]


def _assert_trees(got, want, rtol, what):
    g, w = _flat_np(got), _flat_np(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        assert a.shape == b.shape, f"{what} leaf {i}"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * 1e-3,
                                   err_msg=f"{what} leaf {i}")


def test_train_config_is_the_reference_field_for_field():
    got = [(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(JTrainConfig)]
    assert got == want


OPTIMIZERS = {
    "sgd": (lambda m: m.sgd(0.05)),
    "momentum": (lambda m: m.momentum(0.05, 0.9)),
    "adamw": (lambda m: m.adamw(3e-2, 0.9, 0.95, 1e-8, 0.1)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_the_reference(name, dtype):
    """Three steps on fresh gradients each; the params after each, the moments
    and the step count.  Moments are fp32 whatever the param dtype."""
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    p0 = _np_tree(0)
    jp, tp = _jax(p0, jd), _torch(p0, td)
    js, ts = jo.init(jp), to.init(tp)
    tol = FP32_RTOL if dtype == "float32" else BF16_ULP
    for step in range(3):
        g = _np_tree(10 + step, scale=0.1)
        jp, js = jo.update(_jax(g, jd), js, jp)
        tp, ts = to.update(_torch(g, td), ts, tp)
        _assert_trees(tp, jp, tol, f"{name} {dtype} params after step {step + 1}")
        for field in ("mu", "nu"):
            for a, b in zip(ttree.tree_leaves(getattr(ts, field)),
                            jax.tree_util.tree_leaves(getattr(js, field))):
                assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
                np.testing.assert_allclose(_f32(a), _f32(b), rtol=FP32_RTOL, atol=1e-9)
        assert int(ts.step) == int(js.step) == step + 1 and ts.step.dtype == torch.int32
    for a in ttree.tree_leaves(tp):
        assert a.dtype == td


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(dtype, max_norm):
    """Above the norm (scaled) and below it (unchanged); each leaf keeps its dtype."""
    g = _np_tree(3, scale=2.0)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    got = topt.clip_by_global_norm(_torch(g, td), max_norm)
    want = jopt.clip_by_global_norm(_jax(g, jd), max_norm)
    _assert_trees(got, want, FP32_RTOL if dtype == "float32" else BF16_ULP,
                  f"clip {dtype} {max_norm}")
    assert all(x.dtype == td for x in ttree.tree_leaves(got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_helpers_match_the_reference(dtype):
    a, b = _np_tree(5), _np_tree(6)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    ja, jb, ta, tb = _jax(a, jd), _jax(b, jd), _torch(a, td), _torch(b, td)
    np.testing.assert_allclose(float(ttree.tree_global_norm(ta)),
                               float(jtree.tree_global_norm(ja)), rtol=FP32_RTOL)
    _assert_trees(ttree.tree_add(ta, tb), jtree.tree_add(ja, jb), 0, "tree_add")
    _assert_trees(ttree.tree_sub(ta, tb), jtree.tree_sub(ja, jb), 0, "tree_sub")
    _assert_trees(ttree.tree_scale(ta, 0.5), jtree.tree_scale(ja, 0.5), 0, "tree_scale")
    _assert_trees(ttree.tree_zeros_like(ta), jtree.tree_zeros_like(ja), 0, "tree_zeros_like")
    assert ttree.tree_size(ta) == jtree.tree_size(ja)
    assert ttree.tree_nbytes(ta) == jtree.tree_bytes(ja)


def test_tree_global_norm_holds_on_a_large_fp32_leaf():
    """Squares summed in fp32 by ``torch.sum``, as the reference sums them, stay
    within rtol 2e-6 of float64 on a leaf of 5.8 M elements (a full-width MLP
    weight of two layers); the CPU's ``torch.linalg.vector_norm`` of the same
    fp32 leaf was off by ~1e-4 (torch 2.13)."""
    x = (1e-3 * np.random.default_rng(7).standard_normal((2, 1024, 2816))).astype(np.float32)
    want = float(np.sqrt(np.sum(np.square(x, dtype=np.float64))))
    tree = {"w": torch.from_numpy(x), "b": [torch.from_numpy(x[0, 0])]}
    want_tree = float(np.sqrt(want ** 2 + np.sum(np.square(x[0, 0], dtype=np.float64))))
    np.testing.assert_allclose(float(ttree.tree_global_norm(tree["w"])), want, rtol=FP32_RTOL)
    np.testing.assert_allclose(float(ttree.tree_global_norm(tree)), want_tree, rtol=FP32_RTOL)
    np.testing.assert_allclose(float(jtree.tree_global_norm(jnp.asarray(x))), want,
                               rtol=FP32_RTOL)


def test_tree_leaves_follow_the_reference_flat_order():
    """Dict keys sorted, list items by index, whatever the insertion order."""
    tree = _np_tree(4)
    got = [_f32(x) for x in ttree.tree_leaves(_torch(tree, torch.float32))]
    want = jax.tree_util.tree_leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    paths = [p for p, _ in ttree.tree_leaves_with_path(tree)]
    assert paths[:3] == [("b",), ("blocks", 0, "attn", "wq"), ("blocks", 0, "z")]


def test_optimizer_states_hold_the_reference_shapes():
    tp = _torch(_np_tree(0), torch.bfloat16)
    s = topt.sgd(0.1).init(tp)
    assert all(x.shape == () and x.dtype == torch.float32 for x in ttree.tree_leaves(s.mu))
    s = topt.momentum(0.1).init(tp)
    assert all(x.dtype == torch.float32 for x in ttree.tree_leaves(s.mu))
    assert all(x.shape == () for x in ttree.tree_leaves(s.nu))
    s = topt.adamw(0.1).init(tp)
    for x, p in zip(ttree.tree_leaves(s.nu), ttree.tree_leaves(tp)):
        assert x.dtype == torch.float32 and x.shape == p.shape


@pytest.mark.parametrize("name", ["adamw", "momentum", "sgd"])
def test_make_optimizer_dispatches_as_the_reference(name):
    cfg = TrainConfig(optimizer=name)
    tp = _torch(_np_tree(0), torch.float32)
    g = _torch(_np_tree(1), torch.float32)
    got, _ = topt.make_optimizer(cfg).update(g, topt.make_optimizer(cfg).init(tp), tp)
    jp = _jax(_np_tree(0), jnp.float32)
    jo = jopt.make_optimizer(JTrainConfig(optimizer=name))
    want, _ = jo.update(_jax(_np_tree(1), jnp.float32), jo.init(jp), jp)
    _assert_trees(got, want, FP32_RTOL, name)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer(TrainConfig(optimizer="lamb"))


# ---- checkpoints -----------------------------------------------------------------------


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {name: zf.read(name) for name in zf.namelist()}


def test_checkpoint_keys_are_the_reference_letter_for_letter(tmp_path):
    tree = _np_tree(7)
    p = CheckpointManager(str(tmp_path / "port")).save(1, _torch(tree, torch.float32))
    q = JCkpt(str(tmp_path / "ref")).save(1, _jax(tree, jnp.float32))
    names = sorted(_members(p))
    assert names == sorted(_members(q))
    assert "['blocks']||[0]||['attn']||['wq'].npy" in names


def test_fp32_checkpoints_restore_both_ways(tmp_path):
    tree = _np_tree(8)
    like_t, like_j = _torch(_np_tree(9), torch.float32), _jax(_np_tree(9), jnp.float32)
    port, ref = CheckpointManager(str(tmp_path / "p")), JCkpt(str(tmp_path / "r"))
    port.save(2, _torch(tree, torch.float32))
    ref.save(2, _jax(tree, jnp.float32))
    # the reference's file into the port, the port's into the reference
    got = CheckpointManager(str(tmp_path / "r")).restore(2, like_t)
    want = JCkpt(str(tmp_path / "p")).restore(2, like_j)
    _assert_trees(got, _jax(tree, jnp.float32), 0, "reference file -> port")
    _assert_trees(want, _jax(tree, jnp.float32), 0, "port file -> reference")
    assert list(got) == list(like_t)  # the structure of ``like``
    assert _members(port._path(2)) == _members(ref._path(2))


def test_bf16_checkpoints_are_the_reference_bytes_and_round_trip(tmp_path):
    tree = _np_tree(11)
    port, ref = CheckpointManager(str(tmp_path / "p")), JCkpt(str(tmp_path / "r"))
    tp = _torch(tree, torch.bfloat16)
    a, b = _members(port.save(3, tp)), _members(ref.save(3, _jax(tree, jnp.bfloat16)))
    assert a == b  # every member: header ('<V2') and the raw bf16 bits
    assert b"'descr': '<V2'" in a["['w'].npy"]
    back = port.restore(3, ttree.tree_map(torch.zeros_like, tp))
    for x, y in zip(ttree.tree_leaves(back), ttree.tree_leaves(tp)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
    # the reference's file, read by the port, is the same tree
    from_ref = CheckpointManager(str(tmp_path / "r")).restore(3, tp)
    for x, y in zip(ttree.tree_leaves(from_ref), ttree.tree_leaves(tp)):
        assert torch.equal(x, y)


def test_the_reference_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """A known fault of the reference (``repro/checkpoint/npz.py``'s
    ``arr.astype(leaf.dtype)`` of a ``'<V2'`` record): asserted so that a
    change to it shows here."""
    ref = JCkpt(str(tmp_path))
    tree = _jax(_np_tree(12), jnp.bfloat16)
    ref.save(1, tree)
    with pytest.raises(ValueError, match="No cast function"):
        ref.restore(1, tree)


def test_checkpoint_keeps_the_newest_three_and_leaves_no_temporary(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    t = _torch(_np_tree(0), torch.float32)
    assert ck.latest_step() is None
    for s in (1, 2, 5, 7, 9):
        ck.save(s, t)
    assert ck.steps() == [5, 7, 9] and ck.latest_step() == 9
    assert sorted(os.listdir(tmp_path)) == [f"step_{s:09d}.npz" for s in (5, 7, 9)]


def test_checkpoint_restore_refuses_a_missing_leaf_and_a_shape_mismatch(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    t = _torch(_np_tree(0), torch.float32)
    ck.save(1, t)
    extra = dict(t, extra=torch.zeros(2))
    with pytest.raises(KeyError, match="checkpoint missing leaf") as e:
        ck.restore(1, extra)
    assert e.value.args[0] == "checkpoint missing leaf \"['extra']\""
    wrong = dict(t, w=torch.zeros(7, 5))
    with pytest.raises(ValueError, match="shape mismatch for \\['w'\\]"):
        ck.restore(1, wrong)
