"""The LM zoo's ``encdec`` family (whisper-small, smoke size) against the JAX package.

The smoke config (2 + 2 layers, d 128, 4 heads, ``encoder_seq`` 16, vocab
512, fp32) goes through ``repro.models.encdec`` / ``repro.models.zoo`` and
``repro_torch.models`` from the same key, the same frames and tokens (made
with numpy or ``make_lm_batch`` from a seed) and the converted JAX caches,
with ``tests/test_torch_lm.py``'s tolerances: init leaves within 4 ulps
(truncated-normal and normal draws through the port's ``erf_inv``),
constants exactly; layers and the model in fp32 within 2e-5, in bf16 within
0.0625; integer cache leaves exactly.  On the CPU every decode-step attention
runs ``swa_decode``'s plain version.  The serve CLI calls the prefill
without ``max_seq``, so the self-attention ring holds the prompt's slots and
wraps on the first decode step; the decode test runs 12 steps past a prompt
of 8.
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
from repro.kernels import ref as jref
from repro.models import build_model as jbuild
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro.sharding import split_params
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import swa_decode as swa
from repro_torch.models import build_model
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.utils import prng
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)
from test_torch_lm import _assert_tree_close, _leaves_by_path, _np, _sample_row

ARCH = "whisper-small"
S, STEPS = 8, 12  # without max_seq the 8-slot ring wraps from the first decode step
BUDGET = 20  # S + STEPS: a ring that never wraps
TOL = {"float32": 2e-5, "bfloat16": 0.0625}
ULP4 = 4 * 2.0 ** -23

_ATTN = ("wk", "wo", "wq", "wv")
_MLP = ("b1", "b2", "w1", "w2")
LEAVES = sorted(
    ["/embed", "/pos_embed", "/final_norm", "/final_norm_b"]
    + [f"/encoder/attn/{n}" for n in _ATTN] + [f"/encoder/mlp/{n}" for n in _MLP]
    + [f"/encoder/{n}" for n in ("ln1", "ln1b", "ln2", "ln2b")]
    + [f"/decoder/{a}/{n}" for a in ("self_attn", "cross_attn") for n in _ATTN]
    + [f"/decoder/mlp/{n}" for n in _MLP]
    + [f"/decoder/{n}" for n in ("ln1", "ln1b", "lnx", "lnxb", "ln2", "ln2b")])
_CONSTANT = ("ln1", "ln1b", "ln2", "ln2b", "lnx", "lnxb", "final_norm", "final_norm_b",
             "/b1", "/b2")


@pytest.fixture(scope="module")
def built():
    """Per (dtype, max_seq): (JAX cfg, api, params, jitted prefill and decode)."""
    cache = {}

    def _get(dtype, max_seq=None):
        if (dtype, max_seq) not in cache:
            cfg = jget_smoke(ARCH).replace(dtype=dtype)
            api = jbuild(cfg)
            params, _ = split_params(api.init(jax.random.key(0)))
            prefill = jax.jit(lambda p, b: api.prefill(p, b, max_seq))
            decode = jax.jit(api.decode_step)
            cache[dtype, max_seq] = (cfg, api, params, prefill, decode)
        return cache[dtype, max_seq]

    return _get


def _port(dtype="float32"):
    cfg = get_smoke_config(ARCH).replace(dtype=dtype)
    return cfg, build_model(cfg)


@pytest.fixture(scope="module")
def port_init():
    _, api = _port()
    return _leaves_by_path(convert.tree_to_numpy(api.init(prng.key(0), "cpu")))


def _inputs(cfg, batch=2, seed=3):
    """Frames (numpy, N(0, 0.02)) and tokens for a prompt of S and STEPS more."""
    frames = (0.02 * np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    toks = np.asarray(jmake_lm_batch(jax.random.key(seed), batch, S + STEPS + 1,
                                     cfg.vocab_size)["tokens"])
    return frames, toks


def _to_torch(params):
    return convert.params_tree_from_numpy(jax.tree_util.tree_map(np.asarray, params))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def test_init_encdec_tree_matches_jax(built, port_init):
    _, _, params, _, _ = built("float32")
    assert sorted(port_init) == sorted(_leaves_by_path(tree_to_numpy(params)))
    assert sorted(port_init) == LEAVES


@pytest.mark.parametrize("path", LEAVES)
def test_init_encdec_leaf_matches_jax(built, port_init, path):
    _, _, params, _, _ = built("float32")
    want = _leaves_by_path(tree_to_numpy(params))[path]
    got = port_init[path]
    assert got.shape == want.shape and got.dtype == want.dtype
    if path.endswith(_CONSTANT):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=ULP4, atol=0)


def test_init_encdec_bf16_leaves_are_bf16():
    _, api = _port("bfloat16")
    for path, x in _leaves_by_path(api.init(prng.key(0), "cpu")).items():
        assert x.dtype == torch.bfloat16, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", [((300, 17), 512), ((1001,), 1000), ((7, 5), 1)])
def test_chunked_normal_is_the_single_draw_bitwise(monkeypatch, dtype, shape, chunk):
    """``scaled_normal`` (whisper's ``pos_embed``) across chunk boundaries equals
    the one-call draw bit for bit, and ``jax.random.normal`` within 4 ulps (fp32)."""
    k = prng.fold_in(prng.key(2), 5)
    single = (0.01 * prng.normal(k, shape)).to(dtype)
    monkeypatch.setattr(L, "INIT_CHUNK", chunk)
    got = L.scaled_normal(k, 0.01, shape, dtype)
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, single)
    jk = jax.random.wrap_key_data(jnp.asarray(prng.key_data(k)))
    want = np.asarray(0.01 * jax.random.normal(jk, shape, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=ULP4, atol=0)


def test_whole_init_does_not_depend_on_the_chunk(monkeypatch):
    _, api = _port("bfloat16")
    want = _leaves_by_path(api.init(prng.key(0), "cpu"))
    monkeypatch.setattr(L, "INIT_CHUNK", 4096)
    got = _leaves_by_path(api.init(prng.key(0), "cpu"))
    assert sorted(got) == sorted(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path


def test_init_attention_cross_drops_the_bias():
    cfg = get_smoke_config(ARCH).replace(qkv_bias=True)
    self_p = L.init_attention(prng.key(0), cfg, 2, torch.float32)
    cross_p = L.init_attention(prng.key(0), cfg, 2, torch.float32, cross=True)
    assert sorted(self_p) == ["bk", "bq", "bv", "wk", "wo", "wq", "wv"]
    assert sorted(cross_p) == ["wk", "wo", "wq", "wv"]
    for n in cross_p:
        assert torch.equal(cross_p[n], self_p[n]), n


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 128))).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal((128,))).astype(np.float32)
    b = (0.1 * rng.standard_normal((128,))).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = L.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w), torch.from_numpy(b),
                       1e-5)
    want = JL.layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(w), jnp.asarray(b), 1e-5)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=TOL[dtype] / 8,
                               atol=TOL[dtype] / 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """The tanh-approximate GELU, biases included (drawn non-zero here)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    p = {"w1": rng.standard_normal((64, 96)) / 8, "b1": 0.1 * rng.standard_normal((96,)),
         "w2": rng.standard_normal((96, 64)) / 10, "b2": 0.1 * rng.standard_normal((64,))}
    p = {n: a.astype(np.float32) for n, a in p.items()}
    tdt = getattr(torch, dtype)
    got = L.gelu_mlp({n: torch.from_numpy(a).to(tdt) for n, a in p.items()},
                     torch.from_numpy(x).to(tdt))
    want = JL.gelu_mlp({n: jnp.asarray(a).astype(dtype) for n, a in p.items()},
                       jnp.asarray(x).astype(dtype))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("seq,d", [(16, 128), (1500, 768)])
def test_sinusoid_matches_jax(seq, d):
    """fp32 sines of angles up to 1,499 rad: an ulp of the angle there is 1.2e-4,
    so XLA's and torch's exp / sin, an ulp apart, agree to 2e-4 absolute."""
    got = encdec._sinusoid(seq, d).numpy()
    want = np.asarray(jencdec._sinusoid(seq, d))
    assert got.dtype == np.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if seq <= 16 else 2e-4)


def test_encode_matches_jax(built):
    cfg, _, params, _, _ = built("float32")
    frames, _ = _inputs(cfg)
    got = encdec.encode(_to_torch(params), get_smoke_config(ARCH), torch.from_numpy(frames))
    want = jax.jit(lambda p, f: jencdec.encode(p, cfg, f))(params, jnp.asarray(frames))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL["float32"],
                               atol=TOL["float32"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_seq", [None, BUDGET])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(built, dtype, max_seq):
    """Prefill (frames and S tokens): the last logits and every cache leaf
    (positions and ``enc_pos`` exactly); then STEPS decode steps from the
    converted JAX cache, logits and every leaf after each.  Without
    ``max_seq`` the ring holds S slots and wraps from the first step."""
    cfg, _, params, prefill, decode = built(dtype, max_seq)
    _, api = _port(dtype)
    tparams = _to_torch(params)
    frames, toks = _inputs(cfg)
    tol = TOL[dtype]
    lj, cj = prefill(params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks[:, :S])})
    lt, ct = api.prefill(tparams, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.from_numpy(toks[:, :S].copy())}, max_seq)
    np.testing.assert_allclose(lt.float().numpy(), _np(lj), rtol=tol, atol=tol)
    _assert_tree_close(ct, cj, tol, "prefill cache")
    assert ct["self"]["k"].shape[2] == (max_seq or S)
    assert ct["enc_pos"].dtype == torch.int32 and ct["enc_pos"].is_contiguous()
    tc = convert.lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj))
    for i in range(STEPS):
        lj, cj = decode(params, cj, jnp.asarray(toks[:, S + i]))
        lt, tc = api.decode_step(tparams, tc, torch.from_numpy(toks[:, S + i].copy()))
        np.testing.assert_allclose(lt.float().numpy(), _np(lj), rtol=tol, atol=tol,
                                   err_msg=f"decode step {i}")
        _assert_tree_close(tc, cj, tol, f"decode step {i} cache")


def test_decode_updates_the_cache_in_place(built):
    cfg, _, params, _, _ = built("float32")
    _, api = _port()
    tparams = _to_torch(params)
    frames, toks = _inputs(cfg)
    _, cache = api.prefill(tparams, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks[:, :S].copy())})
    ring = cache["self"]["k"]
    _, out = api.decode_step(tparams, cache, torch.from_numpy(toks[:, S].copy()))
    assert out is cache and out["self"]["k"] is ring
    assert out["self"]["pos"][:, :, 0].tolist() == [[S, S]] * cfg.num_layers  # slot S % S


def test_decode_launches_swa_decode_twice_a_layer(built, monkeypatch):
    """Each decode step's attention goes through ``swa_decode``: the self ring
    and the cached cross K / V, the query at the last frame."""
    cfg, _, params, _, _ = built("float32")
    _, api = _port()
    tparams = _to_torch(params)
    frames, toks = _inputs(cfg)
    _, cache = api.prefill(tparams, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks[:, :S].copy())})
    calls = []
    real = swa.swa_decode

    def spy(q, k, v, kv_pos, pos, window=0, softcap=0.0):
        calls.append((tuple(k.shape), pos.tolist(), window, softcap))
        return real(q, k, v, kv_pos, pos, window, softcap)

    monkeypatch.setattr(swa, "swa_decode", spy)
    api.decode_step(tparams, cache, torch.from_numpy(toks[:, S].copy()))
    hd = cfg.resolved_head_dim
    self_call = ((2, S, cfg.num_kv_heads, hd), [S, S], 0, 0.0)
    cross_call = ((2, cfg.encoder_seq, cfg.num_kv_heads, hd), [cfg.encoder_seq - 1] * 2, 0, 0.0)
    assert calls == [self_call, cross_call] * cfg.num_layers


@pytest.mark.parametrize("seq,pre", [(40, 0), (48, 37), (20, 100)])
def test_init_cache_matches_jax(seq, pre):
    jcfg = jget_smoke(ARCH)
    _, api = _port()
    _assert_tree_close(api.init_cache(2, seq, pre), jzoo._encdec_cache(jcfg, 2, seq, pre), 0.0,
                       f"init_cache({seq}, {pre})")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cross_attention_through_swa_decode(dtype):
    """The decode step's cross-attention call: every one of the 16 frames
    visible with the query at frame 15, against ``ref.swa_decode`` and
    against ``blocked_attention(causal=False)`` (the reference's decode
    form), within 2e-5 (fp32) and 1e-2 (bf16: the blocked form rounds its
    probabilities to bf16 before the PV product)."""
    rng = np.random.default_rng(4)
    B, E, hkv, D = 2, 16, 4, 32
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, hkv, 1, D), (B, E, hkv, D), (B, E, hkv, D)))
    kv_pos = np.tile(np.arange(E, dtype=np.int32), (B, 1))
    pos = np.full((B,), E - 1, np.int32)
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    got = swa.swa_decode(*t, torch.from_numpy(kv_pos), torch.from_numpy(pos))
    assert got.dtype == torch.float32
    j = [jnp.asarray(a).astype(str(dtype)[6:]) for a in (q, k, v)]
    want = jref.swa_decode(*j, jnp.asarray(kv_pos), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=2e-5)
    blocked = L.blocked_attention(t[0].reshape(B, 1, hkv, D), t[1], t[2],
                                  torch.from_numpy(pos)[:, None], torch.from_numpy(kv_pos),
                                  causal=False, block_q=1)
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.reshape(B, 1, hkv, D).numpy(), blocked.float().numpy(),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_prints_the_reference_sample_row(capsys, monkeypatch):
    """``--arch whisper-small`` at the CLI's defaults (4 x 64, 32 tokens: the
    64-slot ring wraps from the first step) against the reference CLI."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH])
    jserve.main()
    want = capsys.readouterr().out
    res = serve.main(["--arch", ARCH, "--device", "cpu"])
    got = capsys.readouterr().out
    assert re.search(r"\[serve\] (\S+):", got).group(1) == ARCH + "-smoke"
    assert _sample_row(got) == _sample_row(want)
    assert tuple(res.tokens.shape) == (4, 32)
    assert tuple(res.cache["self"]["k"].shape[1:3]) == (4, 64)
    assert res.cache["pos"].tolist() == [95] * 4


def test_serve_draws_the_reference_frames():
    """The CLI's frames within 4 ulps of ``0.02 * jax.random.normal(
    fold_in_str(key(0), "frames"), (B, encoder_seq, d))``."""
    from repro.utils import fold_in_str as jfold_in_str
    from repro_torch.launch import serve

    cfg = get_smoke_config(ARCH)
    res = serve.serve(ARCH, batch=2, prompt_len=8, gen=2, device="cpu")
    want = np.asarray(0.02 * jax.random.normal(jfold_in_str(jax.random.key(0), "frames"),
                                               (2, cfg.encoder_seq, cfg.d_model)))
    got = res.prompts["frames"].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ULP4, atol=0)
