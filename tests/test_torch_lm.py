"""The LM zoo's hybrid family (hymba-1.5b, smoke size) against the JAX package.

The same inputs go through ``repro.models`` and ``repro_torch.models``:
weights drawn from the same key (or carried over through ``convert``),
tokens from ``make_lm_batch``, activations made with numpy from a seed.  On
the CPU the port's kernels run their plain versions.  Tolerances:

- init: uniform-derived leaves (``A_log``, ``dt_bias``: exp/log of uniform
  draws) within 2 ulps, truncated-normal leaves within 4 ulps (the port's
  ``erf_inv`` polynomial, ``utils/prng.py``), constants exactly;
- layers and the whole model in fp32: 2e-5 (XLA contracts multiply-adds into
  FMAs and sums in other orders; ~1e-6 through two layers);
- the whole model in bf16: 0.0625 on logits and cache leaves of size <= ~4,
  a few bf16 steps (2^-6 at [2, 4)): both sides round every activation to 8
  significant bits, and XLA may keep fused bf16 intermediates in fp32 where
  torch rounds each op.
"""
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data import make_lm_batch as jmake_lm_batch
from repro.models import build_model as jbuild
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.sharding import split_params
from repro.utils import fold_in_str as jfold_in_str
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.utils import prng
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)

ARCH = "hymba-1.5b"
S, STEPS = 40, 3  # past the 32-token window (the ring wraps), 2.5 SSD chunks of 16
BUDGET = 48  # the serve CLI's max_seq at --prompt-len 40 --gen 8
TOL = {"float32": 2e-5, "bfloat16": 0.0625}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def built():
    """Per dtype: (JAX cfg, api, params, jitted prefill and decode), compiled once."""
    cache = {}

    def _get(dtype):
        if dtype not in cache:
            cfg = jget_smoke(ARCH).replace(dtype=dtype)
            api = jbuild(cfg)
            params, _ = split_params(api.init(jax.random.key(0)))
            prefill = jax.jit(lambda p, b: api.prefill(p, b, BUDGET))
            decode = jax.jit(api.decode_step)
            cache[dtype] = (cfg, api, params, prefill, decode)
        return cache[dtype]

    return _get


def _port(dtype):
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    return cfg, build_model(cfg)


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaves_by_path(tree):
    return dict(_leaf_paths(tree))


_CONSTANT = ("ln1", "ln2", "final_norm", "attn_out_norm", "ssm_out_norm", "norm_w", "conv_b",
             "/D")
_UNIFORM = ("A_log", "dt_bias")
LEAVES = ["/embed", "/final_norm", "/lm_head"] + [
    f"/blocks[0]/{n}" for n in (
        "attn/wk", "attn/wo", "attn/wq", "attn/wv", "attn_out_norm", "ln1", "ln2",
        "mlp/w_down", "mlp/w_gate", "mlp/w_up", "ssm/A_log", "ssm/D", "ssm/conv_b",
        "ssm/conv_w", "ssm/dt_bias", "ssm/in_B", "ssm/in_C", "ssm/in_dt", "ssm/in_x",
        "ssm/in_z", "ssm/norm_w", "ssm/out_proj", "ssm_out_norm")]


@pytest.fixture(scope="module")
def port_init():
    cfg, api = _port("float32")
    return _leaves_by_path(convert.tree_to_numpy(api.init(prng.key(0), "cpu")))


def test_init_lm_tree_matches_jax(built, port_init):
    _, _, params, _, _ = built("float32")
    assert sorted(port_init) == sorted(_leaves_by_path(tree_to_numpy(params)))
    assert sorted(port_init) == sorted(LEAVES)


@pytest.mark.parametrize("path", LEAVES)
def test_init_lm_leaf_matches_jax(built, port_init, path):
    _, _, params, _, _ = built("float32")
    want = _leaves_by_path(tree_to_numpy(params))[path]
    got = port_init[path]
    assert got.shape == want.shape and got.dtype == want.dtype
    if path.endswith(_CONSTANT):
        np.testing.assert_array_equal(got, want)
    elif path.endswith(_UNIFORM):
        np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)


def test_init_lm_bf16_leaves_are_bf16():
    cfg, api = _port("bfloat16")
    params = api.init(prng.key(0), "cpu")
    leaves = _leaves_by_path(params)
    for path, x in leaves.items():
        want = torch.float32 if path.endswith(("A_log", "dt_bias", "/D")) else torch.bfloat16
        assert x.dtype == want, path


@pytest.mark.parametrize("b,s,vocab,seed", [(2, 41, 512, 0), (4, 65, 32001, 1), (3, 20, 100, 2)])
def test_make_lm_batch_tokens_match_jax_exactly(b, s, vocab, seed):
    want = jmake_lm_batch(jfold_in_str(jax.random.key(seed), "prompts"), b, s, vocab)
    got = make_lm_batch(prng.fold_in_str(prng.key(seed), "prompts"), b, s, vocab)
    for k in ("tokens", "targets"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("shape,v,seed", [((2, 41), 512, 0), ((4, 50), 4096, 3), ((7,), 10, 5)])
def test_categorical_matches_jax_exactly(shape, v, seed):
    logits = -1.1 * np.log(np.arange(1, v + 1, dtype=np.float32))
    want = np.asarray(jax.random.categorical(jax.random.key(seed), jnp.asarray(logits),
                                             shape=shape))
    got = prng.categorical(prng.key(seed), torch.from_numpy(logits), shape)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("zero_centered", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(zero_centered, dtype):
    rng = _rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal((64,))).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = L.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), 1e-5, zero_centered)
    want = JL.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w), 1e-5, zero_centered)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=TOL[dtype] / 8,
                               atol=TOL[dtype] / 8)


@pytest.mark.parametrize("style", ["full", "2d", "none"])
@pytest.mark.parametrize("pos_rank", [1, 2])
def test_rope_matches_jax(style, pos_rank):
    rng = _rng(2)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(100, 107) if pos_rank == 1 else rng.integers(0, 5000, (2, 7))
    inv = L.rope_frequencies(32, style, 10_000.0)
    jinv = JL.rope_frequencies(32, style, 10_000.0)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=2e-7)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), inv, style)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), jinv, style)
    # angles up to ~5e3 rad: cos/sin of a large fp32 argument round differently
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["causal", "windowed", "softcap", "decode_ring", "bf16"])
def test_blocked_attention_matches_jax(case):
    rng = _rng(3)
    B, Sq, H, Hkv, D = 2, 23, 6, 2, 32
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sq, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sq, Hkv, D)).astype(np.float32)
    qp = kp = np.broadcast_to(np.arange(Sq), (B, Sq)).astype(np.int32)
    window, cap, block_q, dtype = 0, 0.0, 8, "float32"
    if case == "windowed":
        window = 5
    elif case == "softcap":
        cap = 30.0
    elif case == "decode_ring":  # one query against a wrapped 16-slot ring
        C, p = 16, 40
        q = q[:, :1]
        k, v = k[:, :C], v[:, :C]
        kp = np.broadcast_to(L.ring_positions(p + 1, C).numpy(), (B, C)).astype(np.int32)
        qp = np.full((B, 1), p, np.int32)
        window = 12
    elif case == "bf16":
        dtype = "bfloat16"
    tdt = getattr(torch, dtype)
    got = L.blocked_attention(*[torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
                                for a in (q, k, v)],
                              torch.from_numpy(np.ascontiguousarray(qp)),
                              torch.from_numpy(np.ascontiguousarray(kp)), causal=True,
                              window=window, cap=cap, block_q=block_q)
    want = JL.blocked_attention(*[jnp.asarray(a).astype(dtype) for a in (q, k, v)],
                                jnp.asarray(qp), jnp.asarray(kp), causal=True, window=window,
                                softcap=cap, block_q=block_q)
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=TOL[dtype] / 4,
                               atol=TOL[dtype] / 4)


def test_cache_write_matches_jax():
    rng = _rng(4)
    ck = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    cv = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    cp = rng.integers(-1, 20, (2, 8)).astype(np.int32)
    k = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    v = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    pos = np.array([13, 7], np.int32)
    want = JL.cache_write(*[jnp.asarray(a) for a in (ck, cv, cp, k, v, pos)])
    got = L.cache_write(*[torch.from_numpy(a.copy()) for a in (ck, cv, cp, k, v, pos)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_matches_jax(dtype):
    want = JL.init_cache(2, 16, 3, 8, jnp.dtype(dtype))
    got = L.init_cache(2, 16, 3, 8, getattr(torch, dtype))
    for name in ("k", "v", "pos"):
        assert str(got[name].dtype).endswith(str(want[name].dtype))
        np.testing.assert_array_equal(got[name].float().numpy(), _np(want[name]))


def _layer(params, i=0):
    return jax.tree_util.tree_map(lambda x: x[i], params["blocks"][0]["ssm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_sequence_mode_matches_jax(built, dtype):
    cfg, _, params, _, _ = built(dtype)
    tcfg, _ = _port(dtype)
    p = _layer(params)
    x = (0.5 * _rng(5).standard_normal((2, S, cfg.d_model))).astype(np.float32)
    y, st = jax.jit(lambda p, x: jssm.ssm_forward(p, x, cfg))(p, jnp.asarray(x).astype(dtype))
    tp = convert.params_tree_from_numpy(jax.tree_util.tree_map(np.asarray, p))
    ty, tst = ssm.ssm_forward(tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    tol = TOL[dtype]
    np.testing.assert_allclose(ty.float().numpy(), _np(y), rtol=tol, atol=tol)
    for name in ("h", "conv"):
        np.testing.assert_allclose(tst[name].float().numpy(), _np(st[name]), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_decode_mode_matches_jax(built, dtype):
    cfg, _, params, _, _ = built(dtype)
    tcfg, _ = _port(dtype)
    p = _layer(params, 1)
    rng = _rng(6)
    x = (0.5 * rng.standard_normal((2, 1, cfg.d_model))).astype(np.float32)
    h = rng.standard_normal((2, cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state))
    conv = rng.standard_normal((2, cfg.ssm_conv_width - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state))
    state = {"h": h.astype(np.float32), "conv": conv.astype(np.float32)}
    jstate = {"h": jnp.asarray(state["h"]), "conv": jnp.asarray(state["conv"]).astype(dtype)}
    y, st = jax.jit(lambda p, x, s: jssm.ssm_forward(p, x, cfg, s, decode=True))(
        p, jnp.asarray(x).astype(dtype), jstate)
    tdt = getattr(torch, dtype)
    tp = convert.params_tree_from_numpy(jax.tree_util.tree_map(np.asarray, p))
    tstate = {"h": torch.from_numpy(state["h"]), "conv": torch.from_numpy(state["conv"]).to(tdt)}
    ty, tst = ssm.ssm_forward(tp, torch.from_numpy(x).to(tdt), tcfg, tstate, decode=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(ty.float().numpy(), _np(y), rtol=tol, atol=tol)
    for name in ("h", "conv"):
        np.testing.assert_allclose(tst[name].float().numpy(), _np(st[name]), rtol=tol,
                                   atol=tol, err_msg=name)


# ---------------------------------------------------------------------------
# the whole model: prefill and decode from the same weights and caches
# ---------------------------------------------------------------------------


def _assert_tree_close(got, want, tol, what):
    g, w = _leaves_by_path(convert.tree_to_numpy(got)), _leaves_by_path(
        jax.tree_util.tree_map(_np, want))
    assert sorted(g) == sorted(w), what
    for path in w:
        if path.endswith("pos"):
            np.testing.assert_array_equal(g[path], w[path], err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g[path], w[path], rtol=tol, atol=tol,
                                       err_msg=f"{what} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(built, dtype):
    """Prefill S=40 (the ring wraps, the last SSD chunk is partial): the last
    logits and every cache leaf; then 3 decode steps from the converted JAX
    cache: logits and every cache leaf after each."""
    cfg, _, params, prefill, decode = built(dtype)
    _, api = _port(dtype)
    tparams = convert.params_tree_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    toks = np.asarray(jmake_lm_batch(jax.random.key(3), 2, S + STEPS + 1, cfg.vocab_size)
                      ["tokens"])
    tol = TOL[dtype]
    lj, cj = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
    lt, ct = api.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S].copy())}, BUDGET)
    np.testing.assert_allclose(lt.float().numpy(), _np(lj), rtol=tol, atol=tol)
    _assert_tree_close(ct, cj, tol, "prefill cache")
    tc = convert.lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj))
    for i in range(STEPS):
        lj, cj = decode(params, cj, jnp.asarray(toks[:, S + i]))
        lt, tc = api.decode_step(tparams, tc, torch.from_numpy(toks[:, S + i].copy()))
        np.testing.assert_allclose(lt.float().numpy(), _np(lj), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        _assert_tree_close(tc, cj, tol, f"decode step {i} cache")


def test_init_lm_cache_matches_jax(built):
    cfg, api, _, _, _ = built("float32")
    _, tapi = _port("float32")
    for seq, pre in ((40, 0), (48, 37), (20, 100)):
        _assert_tree_close(tapi.init_cache(2, seq, pre), api.init_cache(2, seq, pre), 0.0,
                           f"init_cache({seq}, {pre})")


@pytest.mark.parametrize("family", ["encdec"])
def test_unported_families_raise_naming_the_roadmap(family):
    """Every family of the reference is ported: ``check_family`` and
    ``build_model`` take whisper-small's ``encdec`` and give its API; an
    unknown family still raises, naming ROADMAP.md."""
    from repro_torch.models import encdec

    cfg = get_smoke_config("whisper-small")
    assert cfg.family == family
    tf.check_family(cfg)
    api = build_model(cfg)
    assert api.cfg is cfg
    params = api.init(prng.key(0), "cpu")
    assert sorted(params) == ["decoder", "embed", "encoder", "final_norm", "final_norm_b",
                              "pos_embed"]
    assert sorted(api.init_cache(2, 8)) == ["enc_pos", "pos", "self"]
    frames = 0.02 * torch.randn((2, cfg.encoder_seq, cfg.d_model))
    tokens = torch.zeros((2, 3), dtype=torch.long)
    logits, cache = api.prefill(params, {"frames": frames, "tokens": tokens})
    assert tuple(logits.shape) == (2, cfg.padded_vocab)
    wk = params["decoder"]["cross_attn"]["wk"][0]
    torch.testing.assert_close(cache["self"]["xk"][0], torch.einsum(
        "bsd,dhk->bshk", encdec.encode(params, cfg, frames), wk))
    bad = get_smoke_config(ARCH).replace(family="no-such-family")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        build_model(bad)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tf.init_lm(prng.key(0), bad)


def _sample_row(out: str):
    return re.search(r"sample row: (\[.*\])", out).group(1)


def test_serve_cli_prints_the_reference_sample_row(capsys, monkeypatch):
    """``repro_torch.launch.serve --device cpu`` at smoke size against the
    reference CLI with the same flags: the same greedy sample row."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    flags = ["--arch", ARCH, "--batch", "2", "--prompt-len", "40", "--gen", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = capsys.readouterr().out
    res = serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.count("[serve]") == 2
    assert _sample_row(got) == _sample_row(want)
    assert tuple(res.tokens.shape) == (2, 8)


def test_serve_cli_needs_a_card_unless_asked_for_the_cpu():
    from repro_torch.launch import serve

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--batch", "1", "--prompt-len", "4", "--gen", "2"])
