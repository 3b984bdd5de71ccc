"""The ``encdec`` family (whisper-small) served sharded on the CPU: four
``gloo`` ranks, a worker process each (``repro_torch.launch.serve.ShardedServer``
on ``make_lm_mesh(4, device="cpu")``), against the reference and the port's
one-process serve.

The reference runs in one subprocess of its own (``tests/_jax_sharded_ref.py``,
four JAX CPU devices): its serve CLI at ``--batch 2 --prompt-len 40 --gen 8``
(the stubbed frames from ``"frames"``, no ``max_seq``: a 40-slot self ring that
the decode steps wrap) with params replicated under ``activation_sharding`` of
a ``(1, 4)`` mesh and ``SERVE_RULES``, and its final cache.  Two configs,
smoke size:

- whisper-small's smoke config: 4 heads, 1 a rank; its MLP (256) and vocab
  (512) shard;
- the 6-head variant (``num_heads = num_kv_heads = 6``, ``d_model`` 192): the
  heads do not divide 4 and replicate (every rank runs every head, no sum is
  taken for the attention), while the MLP and the vocab still shard.  That
  is whisper-small's cut on 16 ranks (12 heads replicated, ffn 192 a rank).

Held, fp32 and bf16: the greedy tokens and the last logits against the
reference (fp32: tokens equal, logits within 2e-5; bf16: teacher-forced with
the reference's tokens, the prefill's and the last step's logits within
0.0625, ``test_torch_lm_sharded.py``'s tolerances) and against the port's
one-process serve; the same with every bias and norm weight perturbed
(seeded numpy noise; at init they are zeros and ones, which would hide a
``b2`` added on every rank), one tree carried into the one-process port and,
cut by ``shard_tree``, into each rank; the ranks' final caches gathered into
the reference's layout (``models.encdec.gather_cache``) against the
reference's and the one-process cache (``CACHE_TOL``); each rank's layout
read off the specs, on ``(1, 4)`` and ``(1, 16)`` meshes, smoke and full;
each rank's drawn blocks bit for bit the whole draw cut; the rank-local cache
shapes and specs; the layouts ``make_rank`` refuses; the CLI.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _shard_workers as workers
from repro_torch import convert
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.launch.steps import cache_specs
from repro_torch.models import build_model
from repro_torch.models.encdec import encdec_param_axes, gather_cache
from repro_torch.sharding import SERVE_RULES, activation_sharding, init_shard, make_rank, \
    shard_tree
from repro_torch.utils import prng
from repro_torch.utils.pytree import tree_cast
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

# ARCH[:key=value,...]: a smoke config with overrides (as _jax_sharded_ref.py reads it)
SIX = "whisper-small:num_heads=6,num_kv_heads=6,d_model=192"
SPECS = ("whisper-small", SIX)
DTYPES = ("float32", "bfloat16")
BATCH, PROMPT, GEN = 2, 40, 8
TOL = {"float32": 2e-5, "bfloat16": 0.0625}
# the final cache holds k / v projections, up to ~4 at this size in either dtype (a
# bf16 ulp there is 2^-6: 0.0625 is 4 of them)
CACHE_TOL = {"float32": 2e-5, "bfloat16": 0.0625}
MESH = {"data": 1, "model": 4}
HERE = os.path.dirname(os.path.abspath(__file__))
# the biases and norm weights of the tree: zeros and ones at init
BIASES = ("b1", "b2", "ln1b", "ln2b", "lnxb", "final_norm_b", "bq", "bk", "bv")
NORMS = ("ln1", "ln2", "lnx", "final_norm")


def smoke(spec: str, dtype: str = "float32"):
    arch, _, over = spec.partition(":")
    kw = dict(item.split("=") for item in over.split(",")) if over else {}
    return get_smoke_config(arch).replace(dtype=dtype, **{k: int(v) for k, v in kw.items()})


class _Reference:
    """The reference's subprocess; ``get()`` waits for its ``.npz``."""

    def __init__(self, tmp):
        src, self.dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref_out.npz")
        np.savez(src)  # no MoE operands
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_jax_sharded_ref.py"), src, self.dst, *SPECS],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._out = None

    def get(self):
        if self._out is None:
            log, _ = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, f"the reference's sharded runs failed:\n{log}"
            self._out = dict(np.load(self.dst))
        return self._out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    r = _Reference(str(tmp_path_factory.mktemp("jax_sharded_encdec")))
    yield r
    if r.proc.poll() is None:
        r.proc.kill()
        r.proc.wait()


@pytest.fixture(scope="module")
def server(ref):
    torch.set_num_threads(1)
    with serve_mod.ShardedServer(make_lm_mesh(4, device="cpu")) as s:
        yield s
    assert not s.pool.alive and not os.path.exists(s._dir)


def _forced(ref, spec, dtype):
    if dtype == "float32":
        return None
    return torch.from_numpy(ref.get()[f"serve/{spec}/{dtype}/tokens"][:, :-1].copy())


_RUNS: dict = {}


def _sharded(server, ref, spec, dtype):
    """The sharded serve of (spec, dtype) through ``ShardedServer.generate``
    (fp32 greedy; bf16 teacher-forced with the reference's tokens, and its
    prefill alone, gen 1), then the same run on every rank with its final
    cache kept (``_shard_workers.serve_states``)."""
    key = (spec, dtype)
    if key not in _RUNS:
        server.load(smoke(spec, dtype))
        forced = _forced(ref, spec, dtype)
        res = server.generate(BATCH, PROMPT, GEN, forced=forced)
        prefill = server.generate(BATCH, PROMPT, 1) if forced is not None else None
        caches = server.run(workers.serve_states, (BATCH, PROMPT, GEN, forced))
        _RUNS[key] = (res, prefill, caches)
    return _RUNS[key]


def _serve_one(cfg, params, forced=None):
    """The port's one-process serve of ``params`` -> (tokens, last logits, cache)."""
    prompts = serve_mod.make_prompts(cfg, BATCH, PROMPT, "cpu")
    tokens, logits, cache, _, _ = serve_mod.generate(
        build_model(cfg), params, prompts, GEN, serve_mod.max_seq_for(cfg, PROMPT, GEN), "cpu",
        forced)
    return tokens, logits.float(), cache


_ONE: dict = {}


def _one_process(ref, spec, dtype):
    """The port's one-process serve of the seed's draw."""
    key = (spec, dtype)
    if key not in _ONE:
        cfg = smoke(spec, dtype)
        params = build_model(cfg).init(prng.fold_in_str(prng.key(0), "init"), "cpu")
        _ONE[key] = _serve_one(cfg, params, _forced(ref, spec, dtype))
    return _ONE[key]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_encdec_serve_matches_the_reference(server, ref, spec, dtype):
    res, prefill, caches = _sharded(server, ref, spec, dtype)
    want = ref.get()
    tokens = want[f"serve/{spec}/{dtype}/tokens"]
    logits = want[f"serve/{spec}/{dtype}/logits"]
    tol = TOL[dtype]
    assert len(res.ranks) == 4 and tuple(res.tokens.shape) == (BATCH, GEN)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens.numpy(), tokens)
    else:
        np.testing.assert_allclose(prefill.logits.numpy(), logits[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(res.logits.numpy(), logits[-1], rtol=tol, atol=tol)
    assert all(r["launches"] == {} and r["peak_bytes"] is None for r in res.ranks)
    assert tuple(res.prompts["frames"].shape) == (BATCH, smoke(spec).encoder_seq,
                                                  smoke(spec).d_model)
    # the cache-keeping run is the same run
    for c in caches:
        assert torch.equal(c["tokens"], res.tokens) and torch.equal(c["logits"], res.logits)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_encdec_serve_matches_one_process(server, ref, spec, dtype):
    res, _, _ = _sharded(server, ref, spec, dtype)
    tokens, logits, _ = _one_process(ref, spec, dtype)
    tol = TOL[dtype]
    if dtype == "float32":
        assert torch.equal(res.tokens, tokens)
    torch.testing.assert_close(res.logits, logits, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_gathered_encdec_cache_matches_the_reference(server, ref, spec, dtype):
    _, _, caches = _sharded(server, ref, spec, dtype)
    got = gather_cache([c["self"] for c in caches], smoke(spec))
    want = ref.get()
    for name in ("k", "v", "xk", "xv"):
        w = want[f"serve/{spec}/{dtype}/self/{name}"]
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, rtol=CACHE_TOL[dtype],
                                   atol=CACHE_TOL[dtype], err_msg=name)
    np.testing.assert_array_equal(got["pos"].numpy(), want[f"serve/{spec}/{dtype}/self/pos"])
    # each rank holds its kv heads: one a rank, or all 6 where they replicate
    cfg = smoke(spec)
    per_rank = cfg.num_kv_heads // 4 if cfg.num_kv_heads % 4 == 0 else cfg.num_kv_heads
    assert all(c["self"][n].shape[3] == per_rank for c in caches for n in ("k", "xk"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_gathered_encdec_cache_matches_one_process(server, ref, spec, dtype):
    _, _, caches = _sharded(server, ref, spec, dtype)
    _, _, cache = _one_process(ref, spec, dtype)
    got = gather_cache([c["self"] for c in caches], smoke(spec))
    for name in ("k", "v", "xk", "xv"):
        torch.testing.assert_close(got[name], cache["self"][name].float(),
                                   rtol=CACHE_TOL[dtype], atol=CACHE_TOL[dtype])
    assert torch.equal(got["pos"], cache["self"]["pos"])


def _perturbed(cfg, seed: int = 7) -> dict:
    """The seed's draw with every bias and norm weight perturbed: a numpy tree
    (biases ``0.2 * N(0, 1)``, norm weights ``1 + 0.2 * N(0, 1)``, in the
    model dtype) -> tensors through ``convert.params_tree_from_numpy``."""
    rng = np.random.default_rng(seed)
    whole = convert.tree_to_numpy(
        build_model(cfg).init(prng.fold_in_str(prng.key(0), "init"), "cpu"))
    hit = []

    def walk(tree, path):
        for name in sorted(tree):
            value = tree[name]
            if isinstance(value, dict):
                walk(value, path + (name,))
            elif name in BIASES or name in NORMS:
                noise = 0.2 * rng.standard_normal(value.shape).astype(np.float32)
                tree[name] = (noise if name in BIASES else 1.0 + noise).astype(value.dtype)
                hit.append(".".join(path + (name,)))

    walk(whole, ())
    assert len(hit) == 16, hit  # the encoder's 6, the decoder's 8, the final norm's 2
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    return tree_cast(convert.params_tree_from_numpy(whole), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_encdec_with_perturbed_biases_matches_one_process(server, spec, dtype):
    """Every bias and norm weight perturbed, one tree: the ranks (each its
    ``shard_tree`` blocks, ``_shard_workers.hold_params``) against the
    one-process serve (fp32: tokens equal, last logits within 2e-5; bf16:
    teacher-forced with the one-process tokens, within 0.0625).  ``b2`` added on
    every rank (four times, as a bias inside the partial sums would be) moves
    the logits far past the tolerance."""
    cfg = smoke(spec, dtype)
    whole = _perturbed(cfg)
    tokens, logits, _ = _serve_one(cfg, whole)
    server.load(cfg)
    shapes = server.run(workers.hold_params, (whole,))
    assert shapes[0]["decoder"]["mlp"]["b1"] == (cfg.num_layers, cfg.d_ff // 4)
    assert shapes[0]["decoder"]["mlp"]["b2"] == (cfg.num_layers, cfg.d_model)
    res = server.generate(BATCH, PROMPT, GEN,
                          forced=tokens[:, :-1] if dtype == "bfloat16" else None)
    tol = TOL[dtype]
    if dtype == "float32":
        assert torch.equal(res.tokens, tokens)
    torch.testing.assert_close(res.logits, logits, rtol=tol, atol=tol)
    # the perturbation reaches the logits, and a b2 counted on each of 4 ranks shows
    _, plain, _ = _serve_one(cfg, build_model(cfg).init(prng.fold_in_str(prng.key(0), "init"),
                                                        "cpu"), tokens[:, :-1])
    _, four_b2, _ = _serve_one(cfg, _with_b2_times(whole, 4), tokens[:, :-1])
    margin = 4 * TOL["bfloat16"]  # 0.25: past either dtype's tolerance
    assert float((plain - logits).abs().max()) > margin
    assert float((four_b2 - logits).abs().max()) > margin


def _with_b2_times(tree, n: int) -> dict:
    out = {k: (_with_b2_times(v, n) if isinstance(v, dict) else v) for k, v in tree.items()}
    if "b2" in out:
        out["b2"] = out["b2"] * n
    return out


# (spec, full width?, ranks) -> (heads, kv heads, heads sharded, ffn, vocab a rank)
LAYOUTS = {
    ("whisper-small", False, 4): (1, 1, True, 64, 128),
    ("whisper-small", False, 16): (4, 4, False, 16, 32),  # 4 heads replicate on 16
    (SIX, False, 4): (6, 6, False, 64, 128),  # 6 heads replicate on 4
    ("whisper-small", True, 4): (3, 3, True, 768, 12_992),
    ("whisper-small", True, 16): (12, 12, False, 192, 3_248),  # 12 heads replicate on 16
}


@pytest.mark.parametrize("spec,full,n", sorted(LAYOUTS))
def test_make_rank_reads_the_encdec_layout_off_the_specs(spec, full, n):
    cfg = get_config(spec) if full else smoke(spec)
    api = build_model(cfg)
    heads, kv, sharded, ffn, vocab = LAYOUTS[spec, full, n]
    for i in range(n):
        r = make_rank(api, {"data": 1, "model": n}, SERVE_RULES, i)
        assert (r.heads, r.kv_heads, r.heads_sharded, r.kv_take) == (heads, kv, sharded, None)
        assert (r.mlp_sharded, r.ffn) == (True, ffn)
        assert (r.vocab, r.vocab_range) == (vocab, (i * vocab, (i + 1) * vocab))
        assert not (r.expert_sharded or r.ssm_sharded)
    one = make_rank(api, {"data": 1, "model": 1}, SERVE_RULES, 0)
    assert not (one.heads_sharded or one.mlp_sharded) and one.vocab_range is None
    assert (one.heads, one.ffn, one.vocab) == (cfg.num_heads, cfg.d_ff, cfg.padded_vocab)


def _leaves(t, path=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], path + (k,))
    else:
        yield ".".join(path), t


@pytest.mark.parametrize("spec", SPECS)
def test_init_shard_draws_the_encdec_blocks_of_the_whole_draw(spec):
    """Every leaf a rank draws is bit for bit the whole draw's block
    (``shard_tree``), at its local shape: the heads and ffn cut, the norms,
    ``b2`` and ``pos_embed`` whole."""
    cfg = smoke(spec)
    api = build_model(cfg)
    key = prng.fold_in_str(prng.key(0), "init")
    whole = api.init(key, "cpu")
    for i in range(4):
        r = make_rank(api, MESH, SERVE_RULES, i)
        got = dict(_leaves(init_shard(api, key, r, "cpu")))
        want = dict(_leaves(shard_tree(whole, api.param_axes(), MESH, SERVE_RULES, r.coords)))
        assert sorted(got) == sorted(want) and len(got) == 34
        for name in got:
            assert torch.equal(got[name], want[name]), name
        for at in ("encoder.attn", "decoder.self_attn", "decoder.cross_attn"):
            assert got[f"{at}.wq"].shape[2] == got[f"{at}.wo"].shape[1] == r.heads
            assert got[f"{at}.wk"].shape[2] == r.kv_heads
        for at in ("encoder", "decoder"):
            assert got[f"{at}.mlp.w1"].shape[2] == got[f"{at}.mlp.b1"].shape[1] == r.ffn
            assert got[f"{at}.mlp.w2"].shape[1] == r.ffn
            assert torch.equal(got[f"{at}.mlp.b2"], dict(_leaves(whole))[f"{at}.mlp.b2"])
        assert got["embed"].shape[0] == r.vocab
        assert torch.equal(got["pos_embed"], whole["pos_embed"])


@pytest.mark.parametrize("spec", SPECS)
def test_init_encdec_cache_holds_the_ranks_kv_heads(spec):
    """Inside ``activation_sharding`` a rank's zero cache and
    ``launch.steps.cache_specs`` have the shapes its prefill leaves: its kv
    heads in ``k`` / ``v`` / ``xk`` / ``xv``."""
    cfg = smoke(spec)
    api = build_model(cfg)
    shape = ShapeConfig("decode", PROMPT + GEN, BATCH, "decode")
    for i in range(4):
        r = make_rank(api, MESH, SERVE_RULES, i)
        with activation_sharding(MESH, SERVE_RULES, r):
            cache = api.init_cache(BATCH, PROMPT)
            specs, axes = cache_specs(api, shape)
        hd, L = cfg.resolved_head_dim, cfg.num_layers
        assert tuple(cache["self"]["k"].shape) == (L, BATCH, PROMPT, r.kv_heads, hd)
        assert tuple(cache["self"]["xk"].shape) == (L, BATCH, cfg.encoder_seq, r.kv_heads, hd)
        assert tuple(specs["self"]["v"].shape) == (L, BATCH, PROMPT + GEN, r.kv_heads, hd)
        assert tuple(specs["self"]["xv"].shape) == (L, BATCH, cfg.encoder_seq, r.kv_heads, hd)
        assert axes["self"]["xk"] == axes["self"]["k"]
    assert api.init_cache(BATCH, PROMPT)["self"]["k"].shape[3] == cfg.num_kv_heads


def test_make_rank_refuses_an_encdec_layout_it_cannot_run():
    api = build_model(smoke("whisper-small"))
    axes = encdec_param_axes(api.cfg)
    # the cross-attention's heads replicated while the self-attention's cut
    cross = dict(axes, decoder=dict(axes["decoder"], cross_attn=dict(
        axes["decoder"]["cross_attn"], wq=("layers", "embed", None, "head_dim"))))
    with pytest.raises(NotImplementedError, match="decoder.cross_attn.wq is not cut"):
        make_rank(api._replace(param_axes=lambda: cross), MESH, SERVE_RULES, 1)
    # the encoder's MLP not cut
    enc = dict(axes, encoder=dict(axes["encoder"], mlp=dict(
        axes["encoder"]["mlp"], w2=("layers", None, "embed"))))
    with pytest.raises(NotImplementedError, match="encoder.mlp.w2's ffn is not cut"):
        make_rank(api._replace(param_axes=lambda: enc), MESH, SERVE_RULES, 0)
    # b2 cut: it would be added on every rank
    b2 = dict(axes, decoder=dict(axes["decoder"], mlp=dict(
        axes["decoder"]["mlp"], b2=("layers", "mlp"))))
    with pytest.raises(NotImplementedError, match="decoder.mlp.b2 is cut"):
        make_rank(api._replace(param_axes=lambda: b2), MESH, SERVE_RULES, 0)
    with pytest.raises(NotImplementedError, match="pos_embed is cut"):
        make_rank(api, MESH, dict(SERVE_RULES, seq=("model",)), 0)
    # kv heads repeated after projection, the heads cut
    rep = build_model(smoke("whisper-small").replace(num_kv_heads=2, kv_repeat=2))
    with pytest.raises(NotImplementedError, match="kv_repeat 2"):
        make_rank(rep, MESH, SERVE_RULES, 0)
    with pytest.raises(NotImplementedError, match="data > 1"):
        make_rank(api, {"data": 2, "model": 2}, SERVE_RULES, 0)


def test_gather_cache_refuses_heads_that_do_not_tile():
    cfg = smoke("whisper-small")
    part = {n: torch.zeros(2, 2, 5, 1, 32) for n in ("k", "v", "xk", "xv")}
    part["pos"] = torch.zeros(2, 2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        gather_cache([part] * 3, cfg)
    got = gather_cache([part] * 4, cfg)
    assert tuple(got["k"].shape) == (2, 2, 5, 4, 32) and tuple(got["pos"].shape) == (2, 2, 5)


def test_sharded_encdec_cli_prints_the_reference_sample_row(ref, capsys):
    """``python -m repro_torch.launch.serve --arch whisper-small --device cpu
    --model-shards 4`` at the reference's flags: its own four ranks, the
    reference's greedy tokens."""
    res = serve_mod.main(["--arch", "whisper-small", "--device", "cpu", "--model-shards", "4",
                          "--batch", str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN)])
    want = ref.get()["serve/whisper-small/float32/tokens"]
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    out = capsys.readouterr().out
    assert f"sample row: {want[0][:16].tolist()}" in out and "rank 3:" in out
