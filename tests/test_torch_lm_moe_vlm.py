"""The LM zoo's ``moe`` and ``vlm`` families (smoke size) against the JAX package.

mixtral-8x7b and phi3.5-moe-42b-a6.6b (``moe``) and internvl2-76b (``vlm``)
go through ``repro.models`` and ``repro_torch.models`` from the same key, the
same tokens (and, for the VLM, the same image embeddings, one numpy array)
and the converted JAX caches, as ``tests/test_torch_lm_families.py`` runs the
dense configs, with its tolerances: init leaves within 4 ulps (truncated
normal), constants exactly; the model in fp32 within 2e-5 and in bf16
within 0.0625.  Prefill is S = 40: mixtral-smoke's 32-slot window ring wraps.

The MoE layer is held against ``repro.models.moe.moe_ffn`` (no mesh: the
reference's single-program dispatch) on identical inputs in both dtypes,
weights and activations drawn with numpy and rounded to bf16 the same way
on both sides; its routing against the reference's ``_route_local``
exactly (expert ids, slots, the kept mask).  A skewed input (every token
leans towards one expert) overflows that expert's capacity, and the test
asserts that copies were dropped; two equal router columns tie exactly, and
the lower expert index must win, as in ``lax.top_k``.
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
from repro.models import moe as jmoe
from repro.sharding import split_params
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import moe
from repro_torch.utils import prng
from test_torch_bridge import _one_thread, tree_to_numpy  # noqa: F401  (autouse fixture)
from test_torch_lm import _assert_tree_close, _leaves_by_path, _np, _sample_row

ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-76b")
MOE_ARCHS = ARCHS[:2]
S, STEPS, GEN = 40, 3, 8
TOL = {"float32": 2e-5, "bfloat16": 0.0625}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_CONSTANT = ("ln1", "ln2", "final_norm")


def _budget(cfg):
    """The serve CLI's max_seq at --prompt-len 40 --gen 8."""
    return S + GEN + cfg.num_image_tokens


def _leaf_names(arch):
    cfg = get_smoke_config(arch)
    ffn = ("moe/router", "moe/w_down", "moe/w_gate", "moe/w_up") if cfg.family == "moe" else (
        "mlp/w_down", "mlp/w_gate", "mlp/w_up")
    block = ("ln1", "ln2", "attn/wk", "attn/wo", "attn/wq", "attn/wv") + ffn
    return ["/embed", "/final_norm", "/lm_head"] + [f"/blocks[0]/{n}" for n in block]


LEAVES = [(arch, path) for arch in ARCHS for path in _leaf_names(arch)]


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _layer_operands(cfg, B, S_, skew, seed=0):
    """One layer's weights and an input, fp32 numpy.  ``skew`` adds a shared
    component along router column 0 to every token, so most tokens rank that
    expert first and overflow its capacity."""
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, ff)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, ff, d)) / np.sqrt(ff)}
    x = rng.standard_normal((B, S_, d))
    if skew:
        col = p["router"][:, 0]
        x = 0.5 * x + skew * col / np.linalg.norm(col)
    return {k: v.astype(np.float32) for k, v in p.items()}, x.astype(np.float32)


def _moe_pair(p, x, cfg, dtype):
    """(port (y, aux), reference (y, aux), port routing, reference routing) on
    identical inputs: the experts' weights and x rounded to ``dtype`` alike, the
    router in fp32 on both sides."""
    tp = {k: torch.from_numpy(v).to(torch.float32 if k == "router" else TDTYPE[dtype])
          for k, v in p.items()}
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else JDTYPE[dtype])
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(TDTYPE[dtype])
    jx = jnp.asarray(x, JDTYPE[dtype])
    got = moe.moe_ffn(tp, tx, cfg)
    want = jax.jit(lambda p_, x_: jmoe.moe_ffn(p_, x_, cfg))(jp, jx)
    N, d = x.shape[0] * x.shape[1], x.shape[2]
    K, E = cfg.experts_per_token, cfg.num_experts
    r = moe.route(tp["router"], tx.reshape(N, d), K)
    je, _, jslot, _ = jmoe._route_local(jx.reshape(N, d), jp["router"], E, K)
    return got, want, r, (np.asarray(je), np.asarray(jslot))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skew", [0.0, 6.0], ids=["balanced", "skewed"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, skew, dtype):
    """y and aux within the dtype's tolerance; expert ids, slots and the kept
    mask exactly.  The balanced input (N = 80, C = 128) drops nothing; the
    skewed one (N = 512, C = 384) must drop copies."""
    cfg = get_smoke_config(arch)
    B, S_ = (2, 40) if not skew else (2, 256)
    p, x = _layer_operands(cfg, B, S_, skew)
    (y, aux), (jy, jaux), r, (je, jslot) = _moe_pair(p, x, cfg, dtype)
    np.testing.assert_array_equal(r.expert.numpy(), je)
    np.testing.assert_array_equal(r.slot.numpy(), jslot)
    N = B * S_
    C = min(jmoe._round_up(max(int(1.25 * 2 * N / cfg.num_experts), 1), 128),
            jmoe._round_up(N, 128))
    assert r.capacity == C
    np.testing.assert_array_equal(r.keep.numpy(), jslot < C)
    drops = int((~r.keep).sum())
    assert drops > 0 if skew else drops == 0, drops
    tol = TOL[dtype]
    assert y.dtype == TDTYPE[dtype] and tuple(y.shape) == x.shape
    np.testing.assert_allclose(y.float().numpy(), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_tie_goes_to_the_lower_expert(dtype):
    """Router columns 2 and 3 are equal and rank second for every token (column
    0 first): the top 2 is (0, 2) everywhere, as ``lax.top_k`` breaks the tie,
    and the layer matches the reference."""
    cfg = get_smoke_config("mixtral-8x7b")
    p, x = _layer_operands(cfg, 2, 40, 0.0, seed=1)
    x = np.abs(x)  # every token's logits are sum(x) times the column's constant
    p["router"] = np.tile(np.array([0.3, 0.1, 0.2, 0.2], np.float32), (cfg.d_model, 1))
    (y, aux), (jy, jaux), r, (je, _) = _moe_pair(p, x, cfg, dtype)
    np.testing.assert_array_equal(je.reshape(-1, 2), np.tile([0, 2], (80, 1)))
    np.testing.assert_array_equal(r.expert.numpy(), je)
    tol = TOL[dtype]
    np.testing.assert_allclose(y.float().numpy(), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("E", [4, 8, 16])
@pytest.mark.parametrize("N", [1, 51, 52, 128, 129, 1024])
def test_capacity_is_the_reference_formula(N, E):
    """``_moe_gspmd``'s capacity, written out as the reference computes it."""
    K, f = 2, 1.25
    want = min(jmoe._round_up(max(int(f * K * N / E), 1), 128), jmoe._round_up(N, 128))
    assert moe.capacity(N, K, E) == want


# ---------------------------------------------------------------------------
# the three models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built():
    """Per (arch, dtype): (JAX cfg, api, params, jitted prefill and decode)."""
    cache = {}

    def _get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg = jget_smoke(arch).replace(dtype=dtype)
            api = jbuild(cfg)
            params, _ = split_params(api.init(jax.random.key(0)))
            prefill = jax.jit(lambda p, b: api.prefill(p, b, _budget(cfg)))
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
    """Every leaf within 4 ulps of the reference's draw; the router in fp32."""
    _, _, params, _, _ = built(arch, "float32")
    want = _leaves_by_path(tree_to_numpy(params))[path]
    got = port_init(arch)[path]
    assert got.shape == want.shape and got.dtype == want.dtype
    if path.endswith(_CONSTANT):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)


def test_router_stays_fp32_in_a_bf16_model():
    _, api = _port("mixtral-8x7b", "bfloat16")
    moe_p = api.init(prng.key(0), "cpu")["blocks"][0]["moe"]
    assert moe_p["router"].dtype == torch.float32
    assert {moe_p[k].dtype for k in ("w_gate", "w_up", "w_down")} == {torch.bfloat16}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_cache_matches_jax(built, arch):
    _, api, _, _, _ = built(arch, "float32")
    _, tapi = _port(arch, "float32")
    for seq, pre in ((40, 0), (52, 37), (20, 100)):
        _assert_tree_close(tapi.init_cache(2, seq, pre), api.init_cache(2, seq, pre), 0.0,
                           f"{arch} init_cache({seq}, {pre})")


def _prefill_and_decode(built, arch, dtype):
    """Prefill S=40 (a VLM's 4 image tokens in front): the last logits and every
    cache leaf; then 3 decode steps from the converted JAX cache: logits and
    every cache leaf after each."""
    cfg, _, params, prefill, decode = built(arch, dtype)
    _, api = _port(arch, dtype)
    tparams = convert.params_tree_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    toks = np.asarray(jmake_lm_batch(jax.random.key(3), 2, S + STEPS + 1, cfg.vocab_size)
                      ["tokens"])
    jb = {"tokens": jnp.asarray(toks[:, :S])}
    tb = {"tokens": torch.from_numpy(toks[:, :S].copy())}
    if cfg.family == "vlm":
        img = 0.02 * np.random.default_rng(5).standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(img), torch.from_numpy(img)
    tol = TOL[dtype]
    lj, cj = prefill(params, jb)
    lt, ct = api.prefill(tparams, tb, _budget(cfg))
    assert int(ct["pos"][0]) == S + cfg.num_image_tokens
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


def test_prefill_and_decode_match_jax_bf16(built):
    _prefill_and_decode(built, "mixtral-8x7b", "bfloat16")


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_prints_the_reference_sample_row(capsys, monkeypatch):
    """``repro_torch.launch.serve --device cpu --arch mixtral-8x7b`` at smoke
    size against the reference CLI with the same flags: the same greedy
    sample row."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    flags = ["--arch", "mixtral-8x7b", "--batch", "2", "--prompt-len", "40", "--gen", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    jserve.main()
    want = capsys.readouterr().out
    res = serve.main(flags + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert re.search(r"\[serve\] (\S+):", got).group(1) == "mixtral-8x7b-smoke"
    assert _sample_row(got) == _sample_row(want)
    assert tuple(res.tokens.shape) == (2, 8)


def test_serve_vlm_draws_the_reference_image_embeddings_and_budget():
    """internvl2-76b: the CLI's image embeddings within 4 ulps of the reference's
    ``0.02 * jax.random.normal(fold_in_str(key(0), "img"), ...)``, placed in
    front of the prompt, and the cache's budget the reference's max_seq."""
    from repro.utils import fold_in_str as jfold_in_str
    from repro_torch.launch import serve

    cfg = get_smoke_config("internvl2-76b")
    res = serve.serve("internvl2-76b", batch=2, prompt_len=40, gen=3, device="cpu")
    want = np.asarray(0.02 * jax.random.normal(jfold_in_str(jax.random.key(0), "img"),
                                               (2, cfg.num_image_tokens, cfg.d_model)))
    got = res.prompts["image_embeds"].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=4 * 2.0 ** -23, atol=0)
    # positions 0..43 prefilled, 2 decode steps: the ring holds max_seq = 40 + 3 + 4 slots
    assert tuple(res.cache["layers"][0]["attn"]["pos"].shape[-1:]) == (47,)
    assert res.cache["pos"].tolist() == [46, 46]


def test_serve_takes_a_config_in_place_of_the_arch():
    """``serve(cfg=...)`` runs a config cut in depth through the CLI's code."""
    from repro_torch.launch import serve

    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").replace(num_layers=1)
    res = serve.serve(batch=2, prompt_len=8, gen=2, device="cpu", cfg=cfg)
    assert len(res.params["blocks"][0]["ln1"]) == 1
    assert tuple(res.tokens.shape) == (2, 2)


def test_serve_cli_refuses_only_the_encdec_arch_naming_the_roadmap(capsys):
    """The CLI takes every LM arch id of the reference, and all of them serve:
    whisper-small (the last one ported) runs at its defaults on the CPU."""
    from repro.configs import ALL_ARCH_IDS
    from repro_torch.configs import LM_ARCHS, PAPER_MODELS
    from repro_torch.launch import serve

    assert set(ALL_ARCH_IDS) - set(PAPER_MODELS) == set(LM_ARCHS)
    res = serve.main(["--arch", "whisper-small", "--device", "cpu"])
    assert capsys.readouterr().out.count("[serve] whisper-small-smoke") == 1
    assert tuple(res.tokens.shape) == (4, 32)
    assert bool(torch.isfinite(res.logits).all())
