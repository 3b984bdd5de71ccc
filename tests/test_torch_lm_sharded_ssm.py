"""The ``ssm`` and ``hybrid`` families served sharded on the CPU: four ``gloo``
ranks, a worker process each (``repro_torch.launch.serve.ShardedServer`` on
``make_lm_mesh(4, device="cpu")``), against the reference and the port's
one-process serve.

The reference runs in one subprocess of its own (``tests/_jax_sharded_ref.py``,
four JAX CPU devices): its serve CLI at ``--batch 2 --prompt-len 40 --gen 8``
with params replicated under ``activation_sharding`` of a ``(1, 4)`` mesh and
``SERVE_RULES``, and its final cache's SSM states.  Three configs, smoke
size:

- mamba2-130m (``ssm``): 16 SSD heads of 32 columns, 4 whole heads a rank;
- hymba-1.5b (``hybrid``): 12 heads, 3 a rank; its 6 attention heads and 2 kv
  heads do not divide 4 and replicate, its MLP shards;
- the half-head variant, hymba-1.5b's smoke config at ``d_model`` 160:
  ``d_inner`` 320, 10 heads of 32, which do not divide 4 and replicate,
  while the 320 inner columns shard, 80 a rank: 2.5 heads, scanned as 5
  virtual heads of 16 columns.  That is hymba-1.5b's cut at full width (50
  heads replicated, 800 columns a rank, 25 virtual heads of 32) at test size.

Held, fp32 and bf16: the greedy tokens and the last logits against the
reference (fp32: tokens equal, logits within 2e-5; bf16: teacher-forced with
the reference's tokens, the prefill's and the last step's logits within
0.0625, ``test_torch_lm_sharded.py``'s tolerances) and against the port's
one-process serve; the ranks' final SSM states gathered into the reference's
layout (``models.ssm.gather_state``) against the reference's cache and the
one-process serve's (``STATE_TOL``); each rank's layout read off the specs;
each rank's drawn blocks bit for bit the whole draw cut (``shard_tree``); the
layouts ``make_rank`` refuses.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _shard_workers as workers
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import build_model
from repro_torch.models.ssm import gather_state
from repro_torch.sharding import SERVE_RULES, init_shard, make_rank, shard_tree
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

# ARCH[:key=value,...]: a smoke config with overrides (as _jax_sharded_ref.py reads it)
SPECS = ("mamba2-130m", "hymba-1.5b", "hymba-1.5b:d_model=160")
DTYPES = ("float32", "bfloat16")
BATCH, PROMPT, GEN = 2, 40, 8
TOL = {"float32": 2e-5, "bfloat16": 0.0625}
# the final SSM states: h is fp32 in both dtypes, its entries up to ~1.3 at this
# size; conv holds the model dtype's projections, up to ~3.7 (a bf16 ulp there
# is 2^-6: 0.0625 is 4 of them)
STATE_TOL = {"float32": 2e-5, "bfloat16": 0.0625}
MESH = {"data": 1, "model": 4}
HERE = os.path.dirname(os.path.abspath(__file__))


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
    r = _Reference(str(tmp_path_factory.mktemp("jax_sharded_ssm")))
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
    state kept (``_shard_workers.serve_states``)."""
    key = (spec, dtype)
    if key not in _RUNS:
        server.load(smoke(spec, dtype))
        forced = _forced(ref, spec, dtype)
        res = server.generate(BATCH, PROMPT, GEN, forced=forced)
        prefill = server.generate(BATCH, PROMPT, 1) if forced is not None else None
        states = server.run(workers.serve_states, (BATCH, PROMPT, GEN, forced))
        _RUNS[key] = (res, prefill, states)
    return _RUNS[key]


_ONE: dict = {}


def _one_process(ref, spec, dtype):
    """The port's one-process serve -> (tokens, last logits, final cache)."""
    key = (spec, dtype)
    if key not in _ONE:
        cfg = smoke(spec, dtype)
        api = build_model(cfg)
        params = api.init(prng.fold_in_str(prng.key(0), "init"), "cpu")
        prompts = serve_mod.make_prompts(cfg, BATCH, PROMPT, "cpu")
        tokens, logits, cache, _, _ = serve_mod.generate(
            api, params, prompts, GEN, serve_mod.max_seq_for(cfg, PROMPT, GEN), "cpu",
            _forced(ref, spec, dtype))
        _ONE[key] = (tokens, logits.float(), cache)
    return _ONE[key]


def _gathered(states, spec):
    """The ranks' final states gathered into the reference's layout, one
    ``{"h", "conv"}`` a sub-layer."""
    cfg = smoke(spec)
    return [gather_state([(s["cols"], s["ssm"][i]) for s in states], cfg)
            for i in range(len(states[0]["ssm"]))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_ssm_serve_matches_the_reference(server, ref, spec, dtype):
    res, prefill, states = _sharded(server, ref, spec, dtype)
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
    # the state-keeping run is the same run
    for s in states:
        assert torch.equal(s["tokens"], res.tokens) and torch.equal(s["logits"], res.logits)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_sharded_ssm_serve_matches_one_process(server, ref, spec, dtype):
    res, _, _ = _sharded(server, ref, spec, dtype)
    tokens, logits, _ = _one_process(ref, spec, dtype)
    tol = TOL[dtype]
    if dtype == "float32":
        assert torch.equal(res.tokens, tokens)
    torch.testing.assert_close(res.logits, logits, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_gathered_ssm_state_matches_the_reference(server, ref, spec, dtype):
    _, _, states = _sharded(server, ref, spec, dtype)
    cfg = smoke(spec)
    got = _gathered(states, spec)
    want = ref.get()
    assert len(got) == sum(1 for k in want if k.startswith(f"serve/{spec}/{dtype}/ssm/")) // 2
    for i, st in enumerate(got):
        for name in ("h", "conv"):
            w = want[f"serve/{spec}/{dtype}/ssm/{i}/{name}"]
            assert tuple(st[name].shape) == w.shape
            np.testing.assert_allclose(st[name].numpy(), w, rtol=STATE_TOL[dtype],
                                       atol=STATE_TOL[dtype], err_msg=f"sub-layer {i} {name}")
    # each rank holds only the block it computes
    for s in states:
        c0, c1 = s["cols"]
        assert s["ssm"][0]["conv"].shape[-1] == (c1 - c0) + 2 * cfg.ssm_state
        heads, hp = s["ssm"][0]["h"].shape[-3:-1]
        assert heads * hp == c1 - c0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_gathered_ssm_state_matches_one_process(server, ref, spec, dtype):
    _, _, states = _sharded(server, ref, spec, dtype)
    _, _, cache = _one_process(ref, spec, dtype)
    whole = [e["ssm"] for e in cache["layers"] if "ssm" in e]
    got = _gathered(states, spec)
    assert len(got) == len(whole)
    for st, w in zip(got, whole):
        for name in ("h", "conv"):
            torch.testing.assert_close(st[name], w[name].float(), rtol=STATE_TOL[dtype],
                                       atol=STATE_TOL[dtype])


# (spec, full width?) -> each rank's (ssm_cols, ssm_hp, number of heads, ssm_parent)
def _whole(cols, hp):
    return [((r * cols, (r + 1) * cols), hp, cols // hp, None) for r in range(4)]


def _virtual(cols, hp, hp_v):
    return [((r * cols, (r + 1) * cols), hp_v, cols // hp_v,
             tuple(c // hp for c in range(r * cols, (r + 1) * cols, hp_v))) for r in range(4)]


SSM_LAYOUTS = {
    ("mamba2-130m", False): _whole(128, 32),
    ("mamba2-130m", True): _whole(384, 64),  # 24 heads, 6 a rank
    ("hymba-1.5b", False): _whole(96, 32),
    ("hymba-1.5b", True): _virtual(800, 64, 32),  # 50 heads replicated: 12.5 a rank
    ("hymba-1.5b:d_model=160", False): _virtual(80, 32, 16),
}


@pytest.mark.parametrize("spec,full", sorted(SSM_LAYOUTS))
def test_make_rank_reads_the_ssm_layout_off_the_specs(spec, full):
    cfg = get_config(spec) if full else smoke(spec)
    api = build_model(cfg)
    for i, (cols, hp, heads, parent) in enumerate(SSM_LAYOUTS[spec, full]):
        r = make_rank(api, MESH, SERVE_RULES, i)
        assert (r.ssm_sharded, r.ssm_cols, r.ssm_hp, r.ssm_parent) == (True, cols, hp, parent)
        assert (cols[1] - cols[0]) // r.ssm_hp == heads
        if parent is not None:  # a virtual head never straddles two parents
            assert all(c // cfg.ssm_head_dim == (c + hp - 1) // cfg.ssm_head_dim
                       for c in range(cols[0], cols[1], hp))
        if cfg.family == "hybrid":  # 25 / 5 and 6 / 2 heads replicate on 4 ranks
            assert not r.heads_sharded and r.heads == cfg.num_heads and r.mlp_sharded
    one = make_rank(api, {"data": 1, "model": 1}, SERVE_RULES, 0)
    assert not one.ssm_sharded and one.ssm_cols == (0, cfg.ssm_d_inner) \
        and one.ssm_parent is None


@pytest.mark.parametrize("spec", SPECS)
def test_init_shard_draws_the_ssm_blocks_of_the_whole_draw(spec):
    """Every leaf a rank draws, the twelve SSM leaves and hymba's
    ``attn_out_norm`` / ``ssm_out_norm`` among them, is bit for bit the whole
    draw's block (``shard_tree``), at its local shape."""
    cfg = smoke(spec)
    api = build_model(cfg)
    key = prng.fold_in_str(prng.key(0), "init")
    whole = api.init(key, "cpu")
    for i in range(4):
        r = make_rank(api, MESH, SERVE_RULES, i)
        got = init_shard(api, key, r, "cpu")
        want = shard_tree(whole, api.param_axes(), MESH, SERVE_RULES, r.coords)
        blk, wblk = got["blocks"][0], want["blocks"][0]
        names = set(blk["ssm"]) | ({"attn_out_norm", "ssm_out_norm"} & set(blk))
        assert len(blk["ssm"]) == 12
        if cfg.family == "hybrid":
            assert {"attn_out_norm", "ssm_out_norm"} <= names
        for name in sorted(blk["ssm"]):
            assert torch.equal(blk["ssm"][name], wblk["ssm"][name]), name
        for name in names - set(blk["ssm"]):
            assert torch.equal(blk[name], wblk[name]), name
        c0, c1 = r.ssm_cols
        assert blk["ssm"]["in_x"].shape[-1] == blk["ssm"]["norm_w"].shape[-1] == c1 - c0
        assert blk["ssm"]["out_proj"].shape[1] == c1 - c0
        assert blk["ssm"]["conv_w"].shape[-1] == cfg.ssm_d_inner + 2 * cfg.ssm_state

        def leaves(t):
            if isinstance(t, dict):
                for k in sorted(t):
                    yield from leaves(t[k])
            elif isinstance(t, list):
                for v in t:
                    yield from leaves(v)
            else:
                yield t

        assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


def test_make_rank_refuses_an_ssm_layout_it_cannot_run():
    api = build_model(smoke("mamba2-130m"))
    # the SSD heads cut 4 a rank while the inner columns stay whole: not their columns
    with pytest.raises(NotImplementedError, match="not theirs"):
        make_rank(api, MESH, dict(SERVE_RULES, ssm_inner=None), 1)
    # B and C's projection cut: the mixer holds it whole
    with pytest.raises(NotImplementedError, match="in_B is cut"):
        make_rank(api, MESH, dict(SERVE_RULES, ssm_state=("model",)), 0)
    with pytest.raises(NotImplementedError, match="data > 1"):
        make_rank(api, {"data": 2, "model": 2}, SERVE_RULES, 0)


def test_gather_state_refuses_columns_that_do_not_tile():
    cfg = smoke("hymba-1.5b:d_model=160")
    part = {"h": torch.zeros(2, 5, 16, 16), "conv": torch.zeros(2, 3, 80 + 32)}
    with pytest.raises(ValueError, match="tile"):
        gather_state([((0, 80), part), ((160, 240), part)], cfg)
    got = gather_state([((c, c + 80), part) for c in range(0, 320, 80)], cfg)
    assert tuple(got["h"].shape) == (2, 10, 32, 16) and tuple(got["conv"].shape) == (2, 3, 352)


@pytest.mark.parametrize("spec", SPECS)
def test_init_lm_cache_holds_the_ranks_blocks(spec):
    """Inside ``activation_sharding`` a rank's zero cache has the shapes its
    prefill leaves: its SSM state block, and hymba's replicated kv heads."""
    from repro_torch.sharding import activation_sharding

    cfg = smoke(spec)
    api = build_model(cfg)
    for i in range(4):
        r = make_rank(api, MESH, SERVE_RULES, i)
        c0, c1 = r.ssm_cols
        with activation_sharding(MESH, SERVE_RULES, r):
            cache = api.init_cache(BATCH, PROMPT + GEN)
        entry = cache["layers"][0]
        L = cfg.num_layers
        assert tuple(entry["ssm"]["h"].shape) == (L, BATCH, (c1 - c0) // r.ssm_hp, r.ssm_hp,
                                                   cfg.ssm_state)
        assert tuple(entry["ssm"]["conv"].shape) == (L, BATCH, cfg.ssm_conv_width - 1,
                                                      c1 - c0 + 2 * cfg.ssm_state)
        if "attn" in entry:
            assert entry["attn"]["k"].shape[3] == cfg.num_kv_heads * cfg.kv_repeat
