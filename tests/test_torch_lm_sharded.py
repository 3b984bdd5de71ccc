"""The LM zoo served sharded on the CPU: four ``gloo`` ranks, a worker process
each (``repro_torch.launch.serve.ShardedServer`` on ``make_lm_mesh(4,
device="cpu")``), against the reference and the port's one-process serve.

The reference runs in one subprocess of its own (``tests/_jax_sharded_ref.py``,
four JAX CPU devices): its serve CLI at ``--batch 2 --prompt-len 40 --gen 8``
with params replicated under ``activation_sharding`` of a ``(1, 4)`` mesh and
``SERVE_RULES``, so that every MoE layer runs ``_moe_shard_map``; and
``_moe_shard_map`` itself on one-layer operands made here.  It starts with
the module and runs while the port's ranks work.

- The whole serve of mixtral-8x7b, phi3.5-moe, internvl2-76b and
  qwen1.5-0.5b (dense, tied embeddings, qkv bias), smoke size: in fp32 the
  greedy tokens equal the reference's and each step's last logits lie within
  2e-5; in bf16 the run is teacher-forced with the reference's tokens and the
  prefill's and last step's logits lie within 0.0625
  (``test_torch_lm_moe_vlm.py``'s tolerances).  Every rank's tokens are equal
  (``ShardedServer.generate`` asserts it).
- The same against the port's one-process serve: the dense and vlm configs
  as they are; the moe configs with the MoE layer's local form at world 1
  (``moe_ffn_local`` on a (1, 1) rank), since the local capacity (rounded to
  8) drops copies at this size where the one-program capacity (rounded to
  128) drops none.
- ``moe_ffn_local`` on the 4 ranks against ``_moe_shard_map`` on the (1, 4)
  mesh, expert-sharded (E = 8, 4; K = 2) and ff-sliced (E = 2, K = 1), fp32
  and bf16, on a skewed input that drops copies; its routing (expert ids, slots, the kept
  mask) against the reference's ``_route_local`` exactly; at world 1 against
  ``_moe_shard_map`` on a (1, 1) mesh.
- The ranks' layouts (``make_rank``, the ssm and hybrid smoke configs' mixer
  among them), the refusals (data > 1, an unported attention layout, CUDA
  without a card), and a rank that fails.  The ssm and hybrid families' serve
  is held in ``test_torch_lm_sharded_ssm.py``, the encdec family's in
  ``test_torch_lm_sharded_encdec.py``.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import _shard_workers as workers
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import build_model, moe
from repro_torch.models import transformer as tf
from repro_torch.sharding import SERVE_RULES, make_rank
from repro_torch.sharding.shard import Rank
from repro_torch.utils.device import LMMesh
from repro_torch.utils.procs import WorkerError
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

ARCHS = ("mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "internvl2-76b", "qwen1.5-0.5b")
DTYPES = ("float32", "bfloat16")
BATCH, PROMPT, GEN = 2, 40, 8
TOL = {"float32": 2e-5, "bfloat16": 0.0625}
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# one-layer MoE cases: (E, K, dtype); E = 8 and 4 expert-sharded on 4 ranks, E = 2
# ff-sliced (at K = 1: with K = E = 2 every expert takes every token, and none drops)
MOE_CASES = {f"e{E}k{K}-{dt}": (E, K, dt) for E, K in ((8, 2), (4, 2), (2, 1)) for dt in DTYPES}
D, FF, B, S = 64, 96, 2, 24
HERE = os.path.dirname(os.path.abspath(__file__))


def _moe_operands(E: int, seed: int = 0) -> dict:
    """One layer's weights and a skewed input, fp32 numpy: every token leans
    along router column 0, so that expert overflows the local capacity."""
    rng = np.random.default_rng(seed + E)
    p = {"router": rng.standard_normal((D, E)) / np.sqrt(D),
         "w_gate": rng.standard_normal((E, D, FF)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, FF)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, FF, D)) / np.sqrt(FF)}
    col = p["router"][:, 0]
    x = 0.5 * rng.standard_normal((B, S, D)) + 3.0 * col / np.linalg.norm(col)
    return {k: v.astype(np.float32) for k, v in dict(p, x=x).items()}


class _Reference:
    """The reference's subprocess; ``get()`` waits for its ``.npz``."""

    def __init__(self, tmp):
        src, self.dst = os.path.join(tmp, "moe_in.npz"), os.path.join(tmp, "ref_out.npz")
        ops = {}
        for case, (E, K, dt) in MOE_CASES.items():
            for k, v in _moe_operands(E).items():
                ops[f"moe/{case}/{k}"] = v
            ops[f"moe/{case}/E"], ops[f"moe/{case}/K"] = np.int64(E), np.int64(K)
            ops[f"moe/{case}/dtype"] = np.array(dt)
        np.savez(src, **ops)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_jax_sharded_ref.py"), src, self.dst, *ARCHS],
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
    r = _Reference(str(tmp_path_factory.mktemp("jax_sharded")))
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


def _cfg(arch, dtype):
    return get_smoke_config(arch).replace(dtype=dtype)


_RUNS: dict = {}


def _sharded(server, ref, arch, dtype):
    """The sharded serve of (arch, dtype): fp32 greedy; bf16 teacher-forced
    with the reference's tokens, and its prefill alone (gen 1)."""
    key = (arch, dtype)
    if key not in _RUNS:
        server.load(_cfg(arch, dtype))
        if dtype == "float32":
            _RUNS[key] = (server.generate(BATCH, PROMPT, GEN), None)
        else:
            forced = torch.from_numpy(ref.get()[f"serve/{arch}/{dtype}/tokens"][:, :-1].copy())
            _RUNS[key] = (server.generate(BATCH, PROMPT, GEN, forced=forced),
                          server.generate(BATCH, PROMPT, 1))
    return _RUNS[key]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_matches_the_reference(server, ref, arch, dtype):
    res, prefill = _sharded(server, ref, arch, dtype)
    want = ref.get()
    tokens = want[f"serve/{arch}/{dtype}/tokens"]
    logits = want[f"serve/{arch}/{dtype}/logits"]
    tol = TOL[dtype]
    assert len(res.ranks) == 4 and tuple(res.tokens.shape) == (BATCH, GEN)
    if dtype == "float32":
        np.testing.assert_array_equal(res.tokens.numpy(), tokens)
    else:
        np.testing.assert_allclose(prefill.logits.numpy(), logits[0], rtol=tol, atol=tol)
    np.testing.assert_allclose(res.logits.numpy(), logits[-1], rtol=tol, atol=tol)
    assert all(r["launches"] == {} and r["peak_bytes"] is None for r in res.ranks)


def _one_process(arch, dtype, forced, monkeypatch):
    """The port's one-process serve; an MoE layer through ``moe_ffn_local`` at
    world 1 (the reference's ``_moe_shard_map`` on a (1, 1) mesh)."""
    cfg = _cfg(arch, dtype)
    if cfg.family == "moe":
        mesh = {"data": 1, "model": 1}
        r1 = Rank(0, 1, mesh, {"data": 0, "model": 0}, SERVE_RULES, expert_sharded=True)
        monkeypatch.setattr(tf, "moe_ffn", lambda p, x, c: moe.moe_ffn_local(p, x, c, r1))
    api = build_model(cfg)
    params = api.init(serve_mod.prng.fold_in_str(serve_mod.prng.key(0), "init"), "cpu")
    prompts = serve_mod.make_prompts(cfg, BATCH, PROMPT, "cpu")
    return serve_mod.generate(api, params, prompts, GEN, serve_mod.max_seq_for(cfg, PROMPT, GEN),
                              "cpu", forced)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_matches_one_process(server, ref, arch, dtype, monkeypatch):
    res, _ = _sharded(server, ref, arch, dtype)
    forced = None
    if dtype == "bfloat16":
        forced = torch.from_numpy(ref.get()[f"serve/{arch}/{dtype}/tokens"][:, :-1].copy())
    tokens, logits, _, _, _ = _one_process(arch, dtype, forced, monkeypatch)
    tol = TOL[dtype]
    if dtype == "float32":
        assert torch.equal(res.tokens, tokens)
    torch.testing.assert_close(res.logits, logits.float(), rtol=tol, atol=tol)


def _moe_case(case):
    E, K, dt = MOE_CASES[case]
    ops = _moe_operands(E)
    dtype = TDTYPE[dt]
    p = {"router": torch.from_numpy(ops["router"])}
    for w in ("w_gate", "w_up", "w_down"):
        p[w] = torch.from_numpy(ops[w]).to(dtype)
    return E, K, dt, p, torch.from_numpy(ops["x"]).to(dtype)


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_local_matches_shard_map(server, ref, case):
    E, K, dt, p, x = _moe_case(case)
    ys = server.pool.run(workers.moe_local, [(p, x, E, K, E % 4 == 0)] * 4)
    for y in ys[1:]:
        assert torch.equal(y, ys[0])
    want = ref.get()[f"moe/{case}/y"]
    np.testing.assert_allclose(ys[0].numpy(), want, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_local_at_world_one_matches_shard_map(ref, case):
    E, K, dt, p, x = _moe_case(case)
    mesh = {"data": 1, "model": 1}
    r1 = Rank(0, 1, mesh, {"data": 0, "model": 0}, SERVE_RULES, expert_sharded=True)
    with torch.no_grad():
        y, _ = moe.moe_ffn_local(p, x, types.SimpleNamespace(num_experts=E,
                                                             experts_per_token=K), r1)
    want = ref.get()[f"moe1/{case}/y"]
    np.testing.assert_allclose(y.float().numpy(), want, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_local_routing_matches_route_local_exactly(case):
    """Expert ids, slots (a dropped copy's at C - 1) and the kept mask equal the
    reference's ``_route_local`` under the local capacity; copies drop."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    E, K, dt, p, x = _moe_case(case)
    n = B * S
    xt = x.reshape(n, D)
    C = moe.local_capacity(n, K, E)
    assert C % 8 == 0 and C == min(moe._round_up(max(int(1.25 * K * n / E), 1), 8),
                                   moe._round_up(n * K, 8))
    r = moe.route(p["router"], xt, K, capacity=C)
    jx = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16 if dt == "bfloat16"
                                                 else jnp.float32)
    fe, _, jslot, _ = jmoe._route_local(jx, jnp.asarray(p["router"].numpy()), E, K)
    keep = np.asarray(jslot) < C
    assert np.array_equal(r.expert.numpy(), np.asarray(fe))
    assert np.array_equal(r.keep.numpy(), keep)
    assert np.array_equal(torch.where(r.keep, r.slot, C - 1).numpy(),
                          np.where(keep, np.asarray(jslot), C - 1))
    assert int((~r.keep).sum()) > 0


# the mamba2 mixer's layout a rank of 4: (ssm_inner columns a rank, SSD head width);
# the smoke configs cut whole heads (mamba2 16 / 4, hymba 12 / 4)
SSM_COLS = {"mamba2-130m": (128, 32), "hymba-1.5b": (96, 32)}


@pytest.mark.parametrize("arch,heads,kv,experts,ffn,vocab,flags", [
    ("mixtral-8x7b", 2, 1, 1, 512, 128, "experts"),
    ("phi3.5-moe-42b-a6.6b", 2, 1, 1, 512, 128, "experts"),
    ("internvl2-76b", 2, 1, 0, 128, 128, "mlp"),
    ("qwen1.5-0.5b", 2, 2, 0, 128, 128, "mlp"),
    ("mamba2-130m", 0, 0, 0, 0, 128, "ssm"),  # no attention, no MLP
    ("hymba-1.5b", 6, 2, 0, 96, 128, "mlp"),  # 6 / 2 heads replicate on 4 ranks
])
def test_make_rank_reads_the_layout_off_the_specs(arch, heads, kv, experts, ffn, vocab, flags):
    api = build_model(get_smoke_config(arch))
    for i in range(4):
        r = make_rank(api, {"data": 1, "model": 4}, SERVE_RULES, i)
        assert (r.heads, r.kv_heads, r.experts, r.ffn, r.vocab) == (heads, kv, experts, ffn,
                                                                    vocab)
        assert r.heads_sharded == (arch not in SSM_COLS)
        assert r.kv_take is None and r.coords == {"data": 0, "model": i}
        assert r.vocab_range == (128 * i, 128 * (i + 1))
        assert (r.expert_sharded, r.mlp_sharded) == (flags == "experts", flags == "mlp")
        if arch in SSM_COLS:
            cols, hp = SSM_COLS[arch]
            assert (r.ssm_sharded, r.ssm_cols, r.ssm_hp, r.ssm_parent) == (
                True, (cols * i, cols * (i + 1)), hp, None)
        else:
            assert not r.ssm_sharded and r.ssm_cols is None
    full = build_model(get_smoke_config(arch).replace(num_layers=2))
    one = make_rank(full, {"data": 1, "model": 1}, SERVE_RULES, 0)
    assert not (one.heads_sharded or one.mlp_sharded or one.expert_sharded
                or one.ssm_sharded) and one.vocab_range is None


def test_make_rank_takes_the_kv_heads_a_rank_attends_from_replicated_kv_weights():
    """chatglm3-6b at full width: its 2 kv heads do not cut over 4 ranks, so
    ``wk`` / ``wv`` replicate, but repeated 8-fold (``kv_repeat``) the cache's
    16 do: rank r projects all 16 and keeps heads 4r-4r+3, those its query
    heads 8r-8r+7 attend."""
    api = build_model(get_config("chatglm3-6b"))
    for i in range(4):
        r = make_rank(api, {"data": 1, "model": 4}, SERVE_RULES, i)
        assert (r.heads, r.kv_heads, r.kv_take) == (8, 4, (4 * i, 4 * i + 4))


def test_sharded_serve_with_replicated_kv_weights_matches_one_process(server, monkeypatch):
    """chatglm3-6b-smoke with ``kv_repeat`` 2: its 2 kv heads replicate, the
    cache's 4 cut one a rank (``Rank.kv_take``); fp32 greedy tokens and last
    logits as the one-process serve's."""
    cfg = get_smoke_config("chatglm3-6b").replace(kv_repeat=2)
    server.load(cfg)
    res = server.generate(BATCH, PROMPT, GEN)
    api = build_model(cfg)
    params = api.init(serve_mod.prng.fold_in_str(serve_mod.prng.key(0), "init"), "cpu")
    prompts = serve_mod.make_prompts(cfg, BATCH, PROMPT, "cpu")
    tokens, logits, _, _, _ = serve_mod.generate(
        api, params, prompts, GEN, serve_mod.max_seq_for(cfg, PROMPT, GEN), "cpu")
    assert torch.equal(res.tokens, tokens)
    torch.testing.assert_close(res.logits, logits, rtol=TOL["float32"], atol=TOL["float32"])


def test_make_rank_refuses_what_is_not_ported():
    mesh = {"data": 1, "model": 4}
    with pytest.raises(NotImplementedError, match="data > 1"):
        make_rank(build_model(get_smoke_config("mixtral-8x7b")), {"data": 2, "model": 2},
                  SERVE_RULES, 0)
    # the ssm / hybrid and encdec layouts that do not run are refused in
    # test_torch_lm_sharded_ssm.py and test_torch_lm_sharded_encdec.py
    # chatglm3-6b-smoke: 8 query heads cut 2 a rank, its 2 kv heads replicated
    with pytest.raises(NotImplementedError, match="not ported"):
        make_rank(build_model(get_smoke_config("chatglm3-6b")), mesh, SERVE_RULES, 0)


def test_meshes_choose_their_backend_and_refuse_cuda_without_a_card():
    mesh = make_lm_mesh(4, device="cpu")
    assert mesh.shape == {"data": 1, "model": 4} and mesh.backend == "gloo"
    assert make_lm_mesh(2, data=2, device="cpu").shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="model"):
        make_lm_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_lm_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA"):
            LMMesh([["cuda:0", "cuda:0"]])


def test_a_rank_that_fails_raises_and_closes_the_pool():
    """An unported layout (a mesh with data = 2) makes every rank raise in
    ``load``: the caller gets ``WorkerError`` naming it, and the pool is
    closed; nothing falls back."""
    s = serve_mod.ShardedServer(make_lm_mesh(1, data=2, device="cpu"))
    try:
        with pytest.raises(WorkerError, match="data = 2 > 1 is not ported"):
            s.load(get_smoke_config("qwen1.5-0.5b"))
        assert not s.pool.alive
    finally:
        s.close()
    assert not os.path.exists(s._dir)
