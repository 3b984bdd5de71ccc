"""The LM zoo's ``ssm`` and ``dense`` families (smoke size) against the JAX package.

mamba2-130m (``ssm``), qwen1.5-0.5b, gemma2-9b, mistral-nemo-12b and
chatglm3-6b (``dense``) go through ``repro.models`` and ``repro_torch.models``
from the same key, the same tokens and the converted JAX caches, as
``tests/test_torch_lm.py`` runs hymba-1.5b, with its tolerances: init leaves
within 2 ulps (uniform-derived) and 4 ulps (truncated normal), constants
exactly; the model in fp32 within 2e-5 and in bf16 within 0.0625.  Prefill is
S = 40: gemma2-smoke's 32-slot local ring wraps and mamba2-smoke's last SSD
chunk of 16 is partial.

The weight draw fills a tensor ``layers.INIT_CHUNK`` elements at a time; the
tests patch a small chunk in and hold the draw bit for bit to the single call
and to ``jax.random``.
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
from repro.sharding import split_params
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.utils import prng
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)
from test_torch_lm import _assert_tree_close, _leaves_by_path, _np, _sample_row

ARCHS = ("mamba2-130m", "qwen1.5-0.5b", "gemma2-9b", "mistral-nemo-12b", "chatglm3-6b")
S, STEPS = 40, 3
BUDGET = 48  # the serve CLI's max_seq at --prompt-len 40 --gen 8
TOL = {"float32": 2e-5, "bfloat16": 0.0625}

_SSM = ("A_log", "D", "conv_b", "conv_w", "dt_bias", "in_B", "in_C", "in_dt", "in_x", "in_z",
        "norm_w", "out_proj")
_CONSTANT = ("ln1", "ln2", "final_norm", "norm_w", "conv_b", "/D", "/bq", "/bk", "/bv")
_UNIFORM = ("A_log", "dt_bias")


def _leaf_names(arch):
    """The parameter leaves the reference's ``init_lm`` builds for ``arch``'s
    smoke config: an ``ssm`` block is ``ln1`` and the mixer; a ``dense`` block
    adds no SSM, and its attention a bias where ``qkv_bias``."""
    cfg = get_smoke_config(arch)
    if cfg.family == "ssm":
        block = ["ln1"] + [f"ssm/{n}" for n in _SSM]
    else:
        attn = ("wk", "wo", "wq", "wv") + (("bk", "bq", "bv") if cfg.qkv_bias else ())
        block = ["ln1", "ln2"] + [f"attn/{n}" for n in attn] + [
            f"mlp/{n}" for n in ("w_down", "w_gate", "w_up")]
    top = ["/embed", "/final_norm"] + ([] if cfg.tie_embeddings else ["/lm_head"])
    period = max(len(cfg.layer_pattern), 1)
    return top + [f"/blocks[{i}]/{n}" for i in range(period) for n in block]


LEAVES = [(arch, path) for arch in ARCHS for path in _leaf_names(arch)]


@pytest.fixture(scope="module")
def built():
    """Per (arch, dtype): (JAX cfg, api, params, jitted prefill and decode)."""
    cache = {}

    def _get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg = jget_smoke(arch).replace(dtype=dtype)
            api = jbuild(cfg)
            params, _ = split_params(api.init(jax.random.key(0)))
            prefill = jax.jit(lambda p, b: api.prefill(p, b, BUDGET))
            decode = jax.jit(api.decode_step)
            cache[arch, dtype] = (cfg, api, params, prefill, decode)
        return cache[arch, dtype]

    return _get


def _port(arch, dtype):
    cfg = get_smoke_config(arch).replace(dtype=dtype)
    return cfg, build_model(cfg)


@pytest.fixture(scope="module")
def port_init():
    cache = {}

    def _get(arch):
        if arch not in cache:
            _, api = _port(arch, "float32")
            cache[arch] = _leaves_by_path(convert.tree_to_numpy(api.init(prng.key(0), "cpu")))
        return cache[arch]

    return _get


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_jax(built, port_init, arch):
    _, _, params, _, _ = built(arch, "float32")
    got = port_init(arch)
    assert sorted(got) == sorted(_leaves_by_path(tree_to_numpy(params)))
    assert sorted(got) == sorted(_leaf_names(arch))


@pytest.mark.parametrize("arch,path", LEAVES)
def test_init_lm_leaf_matches_jax(built, port_init, arch, path):
    _, _, params, _, _ = built(arch, "float32")
    want = _leaves_by_path(tree_to_numpy(params))[path]
    got = port_init(arch)[path]
    assert got.shape == want.shape and got.dtype == want.dtype
    if path.endswith(_CONSTANT):
        np.testing.assert_array_equal(got, want)
    elif path.endswith(_UNIFORM):
        np.testing.assert_allclose(got, want, rtol=2 * 2.0 ** -23, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_cache_matches_jax(built, arch):
    _, api, _, _, _ = built(arch, "float32")
    _, tapi = _port(arch, "float32")
    for seq, pre in ((40, 0), (48, 37), (20, 100)):
        _assert_tree_close(tapi.init_cache(2, seq, pre), api.init_cache(2, seq, pre), 0.0,
                           f"{arch} init_cache({seq}, {pre})")


def _prefill_and_decode(built, arch, dtype):
    """Prefill S=40: the last logits and every cache leaf; then 3 decode steps
    from the converted JAX cache: logits and every cache leaf after each."""
    cfg, _, params, prefill, decode = built(arch, dtype)
    _, api = _port(arch, dtype)
    tparams = convert.params_tree_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    toks = np.asarray(jmake_lm_batch(jax.random.key(3), 2, S + STEPS + 1, cfg.vocab_size)
                      ["tokens"])
    tol = TOL[dtype]
    lj, cj = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
    lt, ct = api.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S].copy())}, BUDGET)
    np.testing.assert_allclose(lt.float().numpy(), _np(lj), rtol=tol, atol=tol)
    _assert_tree_close(ct, cj, tol, f"{arch} prefill cache")
    tc = convert.lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, cj))
    for i in range(STEPS):
        lj, cj = decode(params, cj, jnp.asarray(toks[:, S + i]))
        lt, tc = api.decode_step(tparams, tc, torch.from_numpy(toks[:, S + i].copy()))
        np.testing.assert_allclose(lt.float().numpy(), _np(lj), rtol=tol, atol=tol,
                                   err_msg=f"{arch} decode step {i}")
        _assert_tree_close(tc, cj, tol, f"{arch} decode step {i} cache")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(built, arch):
    _prefill_and_decode(built, arch, "float32")


@pytest.mark.parametrize("arch", ["mamba2-130m", "gemma2-9b"])
def test_prefill_and_decode_match_jax_bf16(built, arch):
    _prefill_and_decode(built, arch, "bfloat16")


@pytest.mark.parametrize("arch", [None, "mamba2-130m"])
def test_serve_cli_prints_the_reference_sample_row(capsys, monkeypatch, arch):
    """``repro_torch.launch.serve --device cpu`` at smoke size against the
    reference CLI with the same flags: the same greedy sample row.  With no
    ``--arch`` both run their default, qwen1.5-0.5b."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    flags = (["--arch", arch] if arch else []) + ["--batch", "2", "--prompt-len", "40",
                                                  "--gen", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = capsys.readouterr().out
    res = serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert re.search(r"\[serve\] (\S+):", got).group(1) == (arch or "qwen1.5-0.5b") + "-smoke"
    assert _sample_row(got) == _sample_row(want)
    assert tuple(res.tokens.shape) == (2, 8)


# ---------------------------------------------------------------------------
# the weight draw, range by range
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,n", [(0, 1), (0, 1000), (999, 3), (5000, 777)])
def test_bits_of_a_range_are_that_slice_of_jax_bits(start, n):
    k = jax.random.fold_in(jax.random.key(7), 3)
    want = np.asarray(jax.random.bits(k, (start + n,)))[start:]
    got = prng.bits(prng.wrap_key_data(np.asarray(jax.random.key_data(k))), (n,), start=start)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,chunk", [((3, 37, 29), 1000), ((4, 250), 1000),
                                         ((1001,), 1000), ((7, 5), 1)])
def test_chunked_dense_init_is_the_single_draw_bitwise(monkeypatch, dtype, shape, chunk):
    """``dense_init`` across chunk boundaries (ragged last chunk, a chunk that
    ends the tensor exactly, one element a chunk) equals the one-call draw bit
    for bit, and ``jax.random.truncated_normal`` within 4 ulps (fp32)."""
    k = prng.fold_in(prng.key(0), 11)
    std = 1.0 / np.sqrt(shape[-1])
    single = (std * prng.truncated_normal(k, -2.0, 2.0, shape)).to(dtype)
    monkeypatch.setattr(L, "INIT_CHUNK", chunk)
    got = L.dense_init(k, shape, shape[-1], dtype)
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, single)
    jk = jax.random.wrap_key_data(jnp.asarray(prng.key_data(k)))
    want = np.asarray(std * jax.random.truncated_normal(jk, -2.0, 2.0, shape, jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=4 * 2.0 ** -23, atol=0)


def test_chunked_embedding_is_the_single_draw_bitwise(monkeypatch):
    k = prng.fold_in(prng.key(1), 2)
    single = L.init_embedding(k, 300, 17, torch.bfloat16)
    monkeypatch.setattr(L, "INIT_CHUNK", 512)
    assert torch.equal(L.init_embedding(k, 300, 17, torch.bfloat16), single)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-130m", "gemma2-9b"])
def test_whole_init_does_not_depend_on_the_chunk(monkeypatch, arch):
    """A smoke model drawn 4,096 elements a chunk equals the default draw,
    leaf for leaf (hymba-1.5b's weights stay what they were)."""
    _, api = _port(arch, "bfloat16")
    want = _leaves_by_path(api.init(prng.key(0), "cpu"))
    monkeypatch.setattr(L, "INIT_CHUNK", 4096)
    got = _leaves_by_path(api.init(prng.key(0), "cpu"))
    assert sorted(got) == sorted(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path


def test_gemma2_long_ctx_config_matches_the_reference():
    """The ``swa-capped`` variant (global layers windowed at 32k) field for field."""
    import dataclasses

    from repro.configs.gemma2_9b import long_ctx_config
    from repro_torch.configs import gemma2_9b_long_ctx
    from repro_torch.models.transformer import cache_len_for, kind_window

    mine, ref = gemma2_9b_long_ctx(), long_ctx_config()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert cache_len_for(mine, "global", 100_000) == 32_768
    assert kind_window(mine, "global", 32_768) == 32_768
