"""The bf16 precision lane of the port against the JAX package (kernels and lane).

The comm lane (``FLConfig.compute_dtype = "bfloat16"``) carries bf16 update
rows, a bf16 fedbuff ring and bf16 chunk partials over fp32 masters,
moments and accumulators; ``param_dtype = "bfloat16"`` makes the master
bf16 too.  What is held here, on the CPU (the wrappers run their plain
versions), inputs drawn with numpy from a seed and rounded to bf16 once by
JAX, the port getting the same bits through ``convert``:

* each kernel's plain version with bf16 rows against ``repro.kernels.ref``
  (the oracle the JAX package itself runs off the TPU): ``fedavg_reduce``
  (B2) within rtol 1e-5 and 1e-6 of ``sum_k |w_k u_k|`` (another summation
  order); ``server_update`` (B3) under every rule with an fp32 and a bf16
  master, and its buffered form (B4) with the ring draining and not, m and
  v within 1e-6 of that scale, params within 1e-4 of it (the adaptive step
  magnifies the sum's error by up to (1 - beta1) / tau = 100), a bf16
  params' also within one bf16 ulp of itself (a last-bit difference of the
  fp32 sum may round it the other way); ``rsu_reduce`` (B5) with
  ``out_dtype=bf16`` bit for bit on dyadic operands and within one bf16
  ulp on random ones, and its chunk walk bit for bit against the JAX
  round's ``partials + part_c`` (two roundings), on operands whose one
  rounding would differ;
* the default lane frozen: an explicit float32 config gives the default
  config's initial state and rounds bit for bit, every rule;
* the carry footprint: the bf16 lane's ``RoundState`` bytes are at most 55%
  of the fp32 lane's at fleet buffer depth, the ring exactly halved, and
  each of the large leaves the size the JAX package's ``carry_footprint``
  gives it;
* three bf16 rounds of ``FLSimulation`` end within 0.02 test accuracy of
  the JAX bf16 run.

One round of each bf16 lane from an injected JAX state is held in
``tests/test_torch_precision_rounds.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.fl import rounds
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from repro_torch.kernels import fedavg_reduce as fedavg_mod
from repro_torch.kernels import rsu_reduce as rsu_mod
from repro_torch.kernels import server_update as su_mod
from repro_torch.utils import prng
from test_torch_bridge import _one_thread, small_fl_kwargs, small_models  # noqa: F401

BF16_ULP = 2.0 ** -7  # one unit in the last place of a bf16 in [1, 2)


def _pair(x, dtype=jnp.float32):
    """A numpy array -> (the JAX array in ``dtype``, the port's tensor with
    the same bits)."""
    j = jnp.asarray(x).astype(dtype)
    return j, convert.params_tree_from_numpy(np.asarray(j))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _server_operands(k, p, seed):
    rng = np.random.default_rng(seed)
    u = (1e-3 * rng.standard_normal((k, p))).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    params = (0.05 * rng.standard_normal(p)).astype(np.float32)
    m = (1e-4 * rng.standard_normal(p)).astype(np.float32)
    v = ((1e-3 * rng.standard_normal(p)) ** 2).astype(np.float32)
    return u, w / w.sum(), params, m, v


# ---------------------------------------------------------------------------
# B2: fedavg_reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,p", [(1, 1), (3, 5), (10, 2049), (7, 4097), (17, 1030)])
def test_fedavg_reduce_plain_bf16_rows_matches_ref(k, p):
    u, w, *_ = _server_operands(k, p, k * 1000 + p)
    (uj, ut), (wj, wt) = _pair(u, jnp.bfloat16), _pair(w)
    assert ut.dtype == torch.bfloat16
    got = fedavg_mod.fedavg_reduce(ut, wt)
    want = np.asarray(jref.fedavg_reduce(uj, wj))
    assert got.dtype == torch.float32
    scale = float((np.abs(_np(wj)) @ np.abs(_np(uj))).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# B3 / B4: server_update and server_update_buffered
# ---------------------------------------------------------------------------
def _assert_server_close(got, want, scale, master):
    for name, a, b, atol in zip(("params", "m", "v"), got, want,
                                (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        b = np.asarray(b)
        if name == "params" and master == "bfloat16":
            assert a.dtype == torch.bfloat16 and b.dtype.name == "bfloat16"
            a, b = a.float().numpy(), b.astype(np.float32)
            np.testing.assert_allclose(a, b, rtol=BF16_ULP, atol=atol, err_msg=name)
        else:
            assert a.dtype == torch.float32 and b.dtype == np.float32, name
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("master", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", range(len(AGGREGATOR_ORDER)))
@pytest.mark.parametrize("k,p", [(1, 3), (10, 2049)])
def test_server_update_plain_bf16_rows_matches_ref(k, p, rule, master):
    u, w, params, m, v = _server_operands(k, p, 7 * k + p + rule)
    (uj, ut), (wj, wt) = _pair(u, jnp.bfloat16), _pair(w)
    (pj, pt) = _pair(params, jnp.dtype(master))
    (mj, mt), (vj, vt) = _pair(m), _pair(v)
    got = su_mod.server_update(ut, wt, pt, mt, vt, rule, 3)
    want = jref.server_update(uj, wj, pj, mj, vj, jnp.int32(rule), jnp.int32(3))
    scale = float((np.abs(_np(wj)) @ np.abs(_np(uj))).max())
    _assert_server_close(got, want, scale, master)


@pytest.mark.parametrize("master", ["float32", "bfloat16"])
@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("rule", [0, 2, 5])  # fedavg, an adaptive rule, fedbuff
def test_server_update_buffered_plain_bf16_ring_matches_ref(rule, drain, master):
    k, kb, p = 4, 3, 2049
    u, w, params, m, v = _server_operands(k, p, rule)
    ring, bw, *_ = _server_operands(kb, p, 100 + rule)
    (uj, ut), (wj, wt) = _pair(u, jnp.bfloat16), _pair(w)
    (rj, rt), (bj, bt) = _pair(ring, jnp.bfloat16), _pair(bw)
    (pj, pt) = _pair(params, jnp.dtype(master))
    (mj, mt), (vj, vt) = _pair(m), _pair(v)
    got = su_mod.server_update_buffered(ut, wt, rt, bt, pt, mt, vt, rule, 2,
                                        torch.tensor(drain))
    want = jref.server_update_buffered(uj, wj, rj, bj, pj, mj, vj, jnp.int32(rule),
                                       jnp.int32(2), jnp.asarray(drain))
    rows = np.concatenate([_np(uj), _np(rj)]) if drain else _np(uj)
    wts = np.concatenate([_np(wj), _np(bj)]) if drain else _np(wj)
    _assert_server_close(got, want, float((np.abs(wts) @ np.abs(rows)).max()), master)


def test_server_update_plain_bf16_master_is_apply_delta_flat_under_fedavg():
    """Rule 0 on a bf16 master: params + delta in fp32, rounded to bf16 once,
    bit for bit ``apply_delta_flat`` (the ("fedavg",) round's step)."""
    from repro_torch.fl.server import apply_delta_flat

    u, w, params, m, v = _server_operands(5, 515, 11)
    ut, pt = torch.from_numpy(u).to(torch.bfloat16), torch.from_numpy(params).to(torch.bfloat16)
    wt, mt, vt = torch.from_numpy(w), torch.from_numpy(m), torch.from_numpy(v)
    p2, m2, v2 = su_mod.server_update(ut, wt, pt, mt, vt, 0, 0)
    assert torch.equal(p2, apply_delta_flat(pt, fedavg_mod.fedavg_reduce(ut, wt)))
    assert m2 is mt and v2 is vt


# ---------------------------------------------------------------------------
# B5: rsu_reduce with bf16 rows and bf16 partials
# ---------------------------------------------------------------------------
def _rsu_operands(k, p, r, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:  # 7 significant bits, integer weights: every sum exact in fp32
        u = (rng.integers(-64, 65, (k, p)) * 2.0 ** -12).astype(np.float32)
        w = rng.integers(0, 5, k).astype(np.float32)
    else:
        u = (1e-3 * rng.standard_normal((k, p))).astype(np.float32)
        w = rng.random(k).astype(np.float32)
    rid = rng.integers(0, r, k).astype(np.int32)
    return u, w, rid


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("k,p,r", [(1, 1, 1), (4, 515, 10), (9, 2049, 4), (7, 301, 40)])
def test_rsu_reduce_plain_bf16_rows_matches_ref(k, p, r, dyadic, out_dtype):
    u, w, rid = _rsu_operands(k, p, r, k + p + r, dyadic)
    (uj, ut), (wj, wt), (ij, it) = _pair(u, jnp.bfloat16), _pair(w), _pair(rid, jnp.int32)
    od = jnp.dtype(out_dtype)
    got, mass = rsu_mod.rsu_reduce(ut, wt, it, r, out_dtype=getattr(torch, out_dtype))
    want, want_mass = jref.rsu_reduce(uj, wj, ij, r, out_dtype=od)
    assert str(got.dtype) == f"torch.{out_dtype}" and want.dtype == od
    a, b = got.float().numpy(), _np(want)
    if dyadic:
        np.testing.assert_array_equal(a, b)
    else:  # one last bit of the fp32 sum may round the bf16 partial the other way
        scale = float(np.abs(np.asarray(jref.rsu_reduce(jnp.abs(uj), wj, ij, r)[0])).max())
        rtol = BF16_ULP if out_dtype == "bfloat16" else 1e-5
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6 * scale)
    np.testing.assert_allclose(mass.numpy(), np.asarray(want_mass), rtol=1e-6, atol=0.0)


def _jax_walk(chunks, r):
    """The JAX round's chunk walk: zeros in bf16, then ``partials + part_c``
    with ``part_c`` the oracle's bf16 partials (two roundings)."""
    partials = jnp.zeros((r, chunks[0][0].shape[1]), jnp.bfloat16)
    for uj, wj, ij in chunks:
        partials = partials + jref.rsu_reduce(uj, wj, ij, r, out_dtype=jnp.bfloat16)[0]
    return partials


def _port_walk(chunks, r):
    carry = None
    for ut, wt, it in chunks:
        carry, _ = rsu_mod.rsu_reduce(ut, wt, it, r, carry=carry, out_dtype=torch.bfloat16)
    return carry


def test_rsu_reduce_bf16_carry_rounds_twice_as_the_jax_round():
    """Chunk sums 2^-8 + 2^-20 on a carry of 1: rounded to bf16 first (2^-8,
    a tie at 1 + 2^-8 that rounds to even, 1.0) as the JAX round rounds
    them, not once (1 + 2^-7)."""
    p, r = 6, 2
    rows = np.zeros((2, p), np.float32)
    rows[0, :], rows[1, :] = 2.0 ** -8, 2.0 ** -20
    first = (np.ones((1, p), np.float32), np.ones(1, np.float32), np.zeros(1, np.int32))
    second = (rows, np.ones(2, np.float32), np.zeros(2, np.int32))
    chunks = [(_pair(u, jnp.bfloat16), _pair(w), _pair(rid, jnp.int32))
              for u, w, rid in (first, second)]
    jchunks = [tuple(j for j, _ in c) for c in chunks]
    tchunks = [tuple(t for _, t in c) for c in chunks]
    want = _np(_jax_walk(jchunks, r))
    got = _port_walk(tchunks, r)
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert (want[0] == 1.0).all() and (want[1] == 0.0).all()
    one_rounding = torch.tensor(1.0 + 2.0 ** -8 + 2.0 ** -20).to(torch.bfloat16)
    assert float(one_rounding) == 1.0 + 2.0 ** -7  # the sum the kernel must not give


@pytest.mark.parametrize("dyadic", [True, False])
def test_rsu_reduce_bf16_chunk_walk_matches_the_jax_round(dyadic):
    """Four chunks of 4 rows into 10 RSUs: bit for bit the JAX walk on dyadic
    operands (every sum exact before each rounding), within one bf16 ulp on
    random ones."""
    k, p, r, b = 16, 515, 10, 4
    u, w, rid = _rsu_operands(k, p, r, 3, dyadic)
    chunks = [(_pair(u[i:i + b], jnp.bfloat16), _pair(w[i:i + b]),
               _pair(rid[i:i + b], jnp.int32)) for i in range(0, k, b)]
    want = _np(_jax_walk([tuple(j for j, _ in c) for c in chunks], r))
    got = _port_walk([tuple(t for _, t in c) for c in chunks], r).float().numpy()
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2 * BF16_ULP, atol=1e-7)


# ---------------------------------------------------------------------------
# the lane
# ---------------------------------------------------------------------------
def _init(fl, tapi, n=20):
    scn = scenario_params(scenario_config("ring", num_vehicles=n))
    state, regions = rounds.init_state(tapi, fl, scn, "mnist", "contextual", prng.key(0),
                                       "cpu")
    return state, rounds.make_round_data(state.key, "mnist", fl, regions, "cpu"), scn


def _assert_states_equal(a, b, what):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "twin":
            assert all(torch.equal(p, q) for p, q in zip(x, y)), f"{what}: twin"
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: {f}"
        else:
            assert x == y, f"{what}: {f}"


def test_default_lane_is_frozen_bitwise():
    """An explicit float32 precision axis is the default config: the same
    initial state and, under every rule, the same two rounds, bit for bit."""
    _, tapi = small_models()
    kw = small_fl_kwargs(20, connection_rate=0.7, select_fraction=0.35)
    default = FLConfig(**kw)
    explicit = FLConfig(**kw, param_dtype="float32", compute_dtype="float32")
    assert rounds.precision_of(explicit) == (torch.float32, torch.float32)
    (s0, data, scn), (s1, _, _) = _init(default, tapi), _init(explicit, tapi)
    _assert_states_equal(s0, s1, "init")
    mb = 636_040.0
    steps = [rounds.make_round_step(tapi.loss, fl, 7, mb, tapi.spec, ("contextual",),
                                    aggregators=AGGREGATOR_ORDER) for fl in (default, explicit)]
    for rule, name in enumerate(AGGREGATOR_ORDER):
        a = b = s0
        for _ in range(2):
            (a, ma), (b, mb_) = steps[0](a, scn, 0, rule, data, True), \
                steps[1](b, scn, 0, rule, data, True)
            _assert_states_equal(a, b, name)
            for f in ma._fields:
                x, y = getattr(ma, f), getattr(mb_, f)
                assert torch.equal(x, y) or bool(torch.isnan(x) & torch.isnan(y)), (name, f)


def _carry_bytes(fl, tapi):
    state, _, _ = _init(fl, tapi, fl.num_clients)
    by_leaf = {}
    for f in state._fields:
        x = getattr(state, f)
        leaves = list(x) if f == "twin" else [x] if isinstance(x, torch.Tensor) else []
        by_leaf[f] = sum(t.numel() * t.element_size() for t in leaves)
    return by_leaf


def test_bf16_lane_carry_footprint_halves():
    """The reference's account (``carry_footprint``: N = 12, a 48-unit MLP,
    a 48-slot ring) on the port's own initial states: the ring halves
    exactly, master and moments stay fp32, the whole carry is at most 55%
    of the fp32 lane's, and the large leaves have the reference's bytes."""
    from repro.launch.hlo_analysis import carry_footprint

    _, tapi = small_models(48)
    kw = dict(num_clients=12, samples_per_client=32, batch_size=16, num_clusters=4,
              local_epochs=1, buffer_size=48)
    f32 = _carry_bytes(FLConfig(**kw), tapi)
    b16 = _carry_bytes(FLConfig(**kw, compute_dtype="bfloat16"), tapi)
    assert 2 * b16["buf_delta"] == f32["buf_delta"]
    for leaf in ("params", "opt_m", "opt_v"):
        assert b16[leaf] == f32[leaf], leaf
    assert sum(b16.values()) <= 0.55 * sum(f32.values()), sum(b16.values()) / sum(f32.values())
    for dtype, port in (("float32", f32), ("bfloat16", b16)):
        ref = carry_footprint(dtype, buffer_size=48)["bytes_by_leaf"]
        for leaf in ("params", "opt_m", "opt_v", "buf_delta", "sketches", "sketch_sign"):
            assert port[leaf] == ref[leaf]["bytes"], (dtype, leaf)
    master = _carry_bytes(FLConfig(**kw, compute_dtype="bfloat16", param_dtype="bfloat16"),
                          tapi)
    assert 2 * master["params"] == f32["params"] and master["opt_m"] == f32["opt_m"]


def test_three_bf16_rounds_end_at_the_jax_accuracy():
    from repro.config import FLConfig as JFLConfig
    from repro.core.scenarios import scenario_config as jscenario_config
    from repro.fl.simulation import FLSimulation as JFLSimulation
    from repro_torch.fl.simulation import FLSimulation

    api, tapi = small_models(32)
    kw = small_fl_kwargs(20, local_epochs=2, batch_size=32, compute_dtype="bfloat16")
    ref = JFLSimulation(api.cfg, JFLConfig(**kw), jscenario_config("ring", num_vehicles=20),
                        "mnist", "contextual", jax.random.key(0)).run(3)
    sim = FLSimulation(tapi.cfg, FLConfig(**kw), scenario_config("ring", num_vehicles=20),
                       "mnist", "contextual", prng.key(0), device="cpu")
    got = sim.run(3)
    assert sim.state.buf_delta.dtype == torch.bfloat16
    assert sim.state.params.dtype == torch.float32
    for a, b in zip(got, ref):
        assert (a.n_selected, a.n_succeeded) == (b.n_selected, b.n_succeeded)
    assert abs(got[-1].test_acc - ref[-1].test_acc) <= 0.02, (got[-1], ref[-1])


def test_bf16_lane_prices_the_halved_upload():
    """The round's latency economics price ``model_bytes * itemsize / 4``: a
    bf16 round's mean predicted latency is the fp32 round's at half the
    model bytes, bit for bit."""
    _, tapi = small_models()
    kw = small_fl_kwargs(20)
    fl16 = FLConfig(**kw, compute_dtype="bfloat16")
    state, data, scn = _init(FLConfig(**kw), tapi)
    mb = 636_040.0
    r16 = rounds.make_round_step(tapi.loss, fl16, 2, mb, tapi.spec, ("contextual",))
    r32 = rounds.make_round_step(tapi.loss, FLConfig(**kw), 2, mb / 2, tapi.spec,
                                 ("contextual",))
    state16 = state._replace(buf_delta=state.buf_delta.to(torch.bfloat16))
    (_, m16), (_, m32) = r16(state16, scn, 0, 0, data, False), r32(state, scn, 0, 0, data, False)
    for f in ("mean_pred_latency", "mean_real_latency", "duration", "n_selected",
              "n_succeeded"):
        assert torch.equal(getattr(m16, f), getattr(m32, f)), f
