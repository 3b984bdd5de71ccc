"""The two-tier lane of the port (hierarchical + client_block) against the JAX package.

What is held:

* ``rsu_sample_mass`` and ``rsu_normalized_weights`` against the JAX
  functions: bit for bit for integer sample counts (and then equal to the
  flat ``normalized_weights``), finite zero weights when RSUs are dark, and
  the flat normalizer under ``mass_norm=False``;
* ``rsu_reduce_plain`` (what the ``rsu_reduce`` wrapper runs on the CPU)
  against the jitted oracle ``repro.kernels.ref.rsu_reduce`` and the Pallas
  kernel in interpret mode, at the reference's edge shapes and the fleet's
  padded last chunk: integer weights
  bit for bit, random operands within rtol 1e-6 / atol 1e-6; a chunk walk
  through the wrapper's in-place ``carry`` equals the chunk-wise composition
  of oracles bit for bit (integer weights); the wrapper's vector width
  divides P and aligns the rows, at both row alignments;
* one whole round from an injected JAX state, through
  ``test_torch_bridge.assert_round_matches`` with ``ROUND_TOL``: the
  hierarchical lane (``client_block=0``) for every registered rule on
  ``rush_hour`` and ``rsu_outage``; the streamed lane (N=20, K=7,
  ``client_block=3``: three chunks, the last padded by 2) for every rule,
  a fedbuff round that both drains and parks, and the streamed round on a
  ring with 40 RSUs (past the 32 that one block of the card's
  ``rsu_reduce`` holds);
* the lane's two ``ValueError``s, the JAX package's messages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenarios import scenario_config as jscenario_config
from repro.core.scenarios import scenario_params as jscenario_params
from repro.fl.aggregators import AGGREGATOR_ORDER as JAGGREGATOR_ORDER
from repro.fl.rounds import flat_spec_of
from repro.fl.rounds import make_round_step as jmake_round_step
from repro.fl.partition import rsu_sample_mass as jrsu_sample_mass
from repro.fl.server import rsu_normalized_weights as jrsu_normalized_weights
from repro.kernels import ref as jref
from repro.kernels.rsu_reduce import rsu_reduce as jrsu_reduce_kernel
from repro.sharding import split_params
from repro.utils import tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.fl import rounds
from repro_torch.fl.aggregators import AGGREGATOR_ORDER, FEDBUFF_IDX
from repro_torch.fl.partition import rsu_sample_mass
from repro_torch.fl.server import normalized_weights, rsu_normalized_weights
from repro_torch.kernels import rsu_reduce as rsu_mod
from test_torch_bridge import (  # noqa: F401  (_one_thread: autouse fixture)
    REGISTRY_ROUND_TOL,
    _one_thread,
    assert_round_matches,
    data_to_numpy,
    jax_experiment,
    small_fl_kwargs,
    small_models,
    state_to_numpy,
)

RULES = range(len(AGGREGATOR_ORDER))
# the registry round's tolerances, but the server moment within half an ulp
# of the params: on rsu_outage, fedavgm's momentum picks up the server
# step's rounding at |params| ~ 0.34 (1.5e-8); the flat lane drifts as much
ROUND_TOL = dict(REGISTRY_ROUND_TOL, opt_m=(0.0, 1.5e-8))


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ---------------------------------------------------------------------------
# weight routing
# ---------------------------------------------------------------------------
_jweights = jax.jit(jrsu_normalized_weights, static_argnums=(4,),
                    static_argnames=("mass_norm",))


def _routing(n, r, seed, p_mask=0.6):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 9, n).astype(np.float32)
    mask = rng.random(n) < p_mask
    rid = rng.integers(0, r, n).astype(np.int32)
    return counts, mask, rid


@pytest.mark.parametrize("n,r", [(13, 7), (1, 1), (100, 10)])
def test_rsu_weights_match_jax_and_the_flat_weights_bitwise(n, r):
    counts, mask, rid = _routing(n, r, n + r)
    live = np.ones(r, bool)
    jw, jmass, jtotal = _jweights(mask, counts, rid, live, r)
    w, mass, total = rsu_normalized_weights(_t(mask), _t(counts), _t(rid), _t(live), r)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(mass.numpy(), np.asarray(jmass))
    assert float(total) == float(jtotal) == float((mask * counts).sum())
    # every RSU live and integer counts: the flat weights, bit for bit
    assert torch.equal(w, normalized_weights(_t(mask), _t(counts)))
    np.testing.assert_array_equal(
        rsu_sample_mass(_t(mask * counts), _t(rid), r).numpy(),
        np.asarray(jax.jit(jrsu_sample_mass, static_argnums=2)(mask * counts, rid, r)))


def test_dark_rsus_give_finite_zero_weights():
    n, r = 10, 5
    counts = np.full(n, 4.0, np.float32)
    live = np.array([True, False, True, True, False])
    rid = np.random.default_rng(2).choice([0, 2, 3], n).astype(np.int32)
    for mask in (np.ones(n, bool), np.zeros(n, bool)):
        jw, jmass, jtotal = _jweights(mask, counts, rid, live, r)
        w, mass, total = rsu_normalized_weights(_t(mask), _t(counts), _t(rid), _t(live), r)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(mass.numpy(), np.asarray(jmass))
        assert torch.isfinite(w).all() and float(mass[1]) == float(mass[4]) == 0.0
        assert float(total) == float(jtotal)
    assert torch.equal(w, torch.zeros(n))
    # a client attached to a dark RSU: its mass is dropped from the normalizer
    rid[0] = 1
    w, _, total = rsu_normalized_weights(torch.ones(n, dtype=torch.bool), _t(counts),
                                         _t(rid), _t(live), r)
    assert float(total) == 4.0 * (n - 1)


def test_mass_norm_false_normalizes_by_the_flat_sum():
    """The stale lane: discounted, non-integer weights keep the flat sum."""
    n, r = 17, 6
    counts, mask, rid = _routing(n, r, 5, p_mask=1.0)
    counts = counts * np.random.default_rng(6).random(n).astype(np.float32)
    live = np.ones(r, bool)
    live[2] = False
    jw, jmass, jtotal = _jweights(mask, counts, rid, live, r, mass_norm=False)
    w, mass, total = rsu_normalized_weights(_t(mask), _t(counts), _t(rid), _t(live), r,
                                            mass_norm=False)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=1e-6)
    assert float(total) == float(jtotal)


# ---------------------------------------------------------------------------
# rsu_reduce: the plain version against the oracle and the Pallas kernel
# ---------------------------------------------------------------------------
_jref = jax.jit(jref.rsu_reduce, static_argnums=3)


def _operands(k, p, r, seed=0, int_w=False):
    rng = np.random.default_rng(seed * 101 + k * 7 + p + r)
    u = rng.normal(size=(k, p)).astype(np.float32)
    w = (rng.integers(0, 5, k) if int_w else rng.random(k)).astype(np.float32)
    rid = rng.integers(0, r, k).astype(np.int32)
    return u, w, rid


@pytest.mark.parametrize("k,p,r,mode", [
    (1, 515, 10, "rand"),    # K=1 cohort
    (7, 515, 10, "rand"),    # P off the interpret kernel's 256 block
    (5, 2049, 1, "rand"),    # a single RSU, P one past a block edge
    (9, 257, 6, "same"),     # every client on the same RSU
    (8, 300, 5, "hole"),     # one RSU never attached: an exactly-zero row
    (8, 300, 5, "masked"),   # one RSU's clients all carry weight 0
    (6, 300, 5, "int"),      # integer weights
    (32, 515, 10, "padded"),  # the fleet's last chunk: 4 clients, 28 padding slots
])
def test_rsu_reduce_plain_matches_ref_and_interpret_kernel(k, p, r, mode):
    u, w, rid = _operands(k, p, r, int_w=mode == "int")
    if mode == "padded":  # as fl/rounds.py pads: weight 0, id 0
        w[4:], rid[4:] = 0.0, 0
    if mode == "same":
        rid[:] = r - 1
    elif mode == "hole":
        rid[rid == 2] = 3
    elif mode == "masked":
        w = w * (rid != 2)
    jp, jm = _jref(u, w, rid, r)
    kp, km = jrsu_reduce_kernel(u, w, rid, r, block_p=256, interpret=True)
    before = rsu_mod.launches
    tp, tm = rsu_mod.rsu_reduce(_t(u), _t(w), _t(rid), r)
    assert rsu_mod.launches == before  # CPU tensors never reach the kernel
    assert tp.shape == (r, p) and tm.shape == (r,) and tp.dtype == torch.float32
    for want in ((jp, jm), (kp, km)):
        if mode == "int":
            np.testing.assert_array_equal(tp.numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(tm.numpy(), np.asarray(want[1]))
        else:
            np.testing.assert_allclose(tp.numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(tm.numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    if mode in ("hole", "masked"):
        assert torch.equal(tp[2], torch.zeros(p)) and float(tm[2]) == 0.0


@pytest.mark.parametrize("offset", [0, 2])  # floats into the storage: 16- and 8-byte aligned
@pytest.mark.parametrize("p", [1, 3, 515, 2049, 4096, 159_010, 159_011])
def test_rsu_reduce_vector_width_divides_p_and_aligns_rows(p, offset):
    """The wrapper's one launch choice: the widest vector width that
    divides P and aligns the update rows and the partials (the kernel's
    column runs are then whole and aligned; the card tests cover its
    layout at ragged P and 8-byte rows)."""
    u = torch.empty(2 * p + offset)[offset:].view(2, p)
    out = torch.empty((3, p))
    vec = rsu_mod.vector_width(p, u, out)
    assert p % vec == 0 and u.data_ptr() % (4 * vec) == 0 and out.data_ptr() % (4 * vec) == 0
    assert vec == (1 if p % 2 else 2 if p % 4 or offset else 4)
    assert rsu_mod.vector_width(p, out) == (1 if p % 2 else 2 if p % 4 else 4)


def test_rsu_reduce_chunk_walk_composes_chunkwise():
    """The round's walk: the first chunk without a carry, the rest added to
    it in place.  Integer weights: bit for bit the chunk-wise composition
    of oracles and the Pallas kernel's k-blocked walk; within 1e-6 of the
    one-contraction oracle."""
    k, p, r, bk = 16, 300, 5, 4
    u, w, rid = _operands(k, p, r, int_w=True)
    acc, macc = np.zeros((r, p), np.float32), np.zeros(r, np.float32)
    carry = None
    for i in range(0, k, bk):
        jp, jm = _jref(u[i:i + bk], w[i:i + bk], rid[i:i + bk], r)
        acc, macc = acc + np.asarray(jp), macc + np.asarray(jm)
        carry, mass = rsu_mod.rsu_reduce(_t(u[i:i + bk]), _t(w[i:i + bk]),
                                         _t(rid[i:i + bk]), r, carry=carry)
        np.testing.assert_array_equal(mass.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(carry.numpy(), acc)
    kp, _ = jrsu_reduce_kernel(u, w, rid, r, block_p=256, block_k=bk, interpret=True)
    np.testing.assert_array_equal(carry.numpy(), np.asarray(kp))
    np.testing.assert_allclose(carry.numpy(), np.asarray(_jref(u, w, rid, r)[0]),
                               rtol=1e-6, atol=1e-6)


def test_rsu_reduce_ids_out_of_range_contribute_nothing():
    u, w, rid = _operands(6, 40, 4)
    rid[1], rid[4] = 4, 9
    p, m = rsu_mod.rsu_reduce(_t(u), _t(w), _t(rid), 4)
    keep = np.isin(np.arange(6), [1, 4], invert=True)
    p2, m2 = rsu_mod.rsu_reduce(_t(u[keep]), _t(w[keep]), _t(rid[keep]), 4)
    torch.testing.assert_close(p, p2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m, m2, rtol=1e-6, atol=1e-6)


def test_rsu_reduce_refuses_devices_it_does_not_serve():
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError):
        rsu_mod.rsu_reduce(x, x[:, 0], torch.zeros(2, dtype=torch.int32, device="meta"), 3)


# ---------------------------------------------------------------------------
# whole rounds from an injected JAX state
# ---------------------------------------------------------------------------
def _env(n, scenarios, traffic_kw=None, **kw):
    """Both sides' full-registry round programs for one two-tier config
    (``traffic_kw`` overrides the scenarios' traffic fields)."""
    state, data, fl, api = jax_experiment(scenario=scenarios[0], n_clients=n, warmup=False,
                                          hierarchical=True, **kw)
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    jstep = jax.jit(jmake_round_step(api.loss, fl, fl.n_select, mb, flat_spec_of(spec_tree),
                                     ("contextual",), aggregators=JAGGREGATOR_ORDER))
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(n, hierarchical=True, **kw))
    tstep = rounds.make_round_step(tapi.loss, tfl, tfl.n_select, mb, tapi.spec,
                                   ("contextual",), aggregators=AGGREGATOR_ORDER)
    tkw = traffic_kw or {}
    scn = {s: (jscenario_params(jscenario_config(s, num_vehicles=n, **tkw)),
               scenario_params(scenario_config(s, num_vehicles=n, **tkw))) for s in scenarios}
    return dict(state=state, data=data, jstep=jstep, tstep=tstep, scn=scn, fl=tfl)


def _one_round(env, scenario, rule, state):
    """One round of ``rule`` from the JAX ``state`` on both sides."""
    jscn, scn = env["scn"][scenario]
    zero, ai = jnp.int32(0), jnp.int32(rule)
    js2, jm2 = env["jstep"](state, jscn, zero, ai, env["data"], True)
    ts = convert.state_from_numpy(state_to_numpy(state))
    td = convert.data_from_numpy(data_to_numpy(env["data"]))
    ts2, tm2 = env["tstep"](ts, scn, 0, rule, td, True)
    assert_round_matches(tm2, ts2, jm2, js2, ROUND_TOL)
    return jm2


@pytest.fixture(scope="module")
def hier_env():
    """The unblocked two-tier lane at CR 0.7 (some stragglers)."""
    return _env(20, ("rush_hour", "rsu_outage"), connection_rate=0.7)


@pytest.mark.parametrize("scenario", ["rush_hour", "rsu_outage"])
@pytest.mark.parametrize("rule", RULES)
def test_hierarchical_round_matches_the_jax_round(hier_env, scenario, rule):
    """From the state after one JAX round of this rule (moments and ring
    no longer zero)."""
    jscn = hier_env["scn"][scenario][0]
    js, _ = hier_env["jstep"](hier_env["state"], jscn, jnp.int32(0), jnp.int32(rule),
                              hier_env["data"], True)
    _one_round(hier_env, scenario, rule, js)


@pytest.fixture(scope="module")
def streamed_env():
    """The streamed lane: K = 7 slots in chunks of 3 (the last padded by 2),
    CR 0.5 and a fill threshold of 1 so fedbuff parks and drains."""
    env = _env(20, ("rush_hour",), connection_rate=0.5, buffer_fill=1, select_fraction=0.35,
               client_block=3)
    assert env["fl"].n_select == 7
    return env


@pytest.mark.parametrize("rule", RULES)
def test_streamed_round_matches_the_jax_round(streamed_env, rule):
    env = streamed_env
    jscn = env["scn"]["rush_hour"][0]
    js, _ = env["jstep"](env["state"], jscn, jnp.int32(0), jnp.int32(rule), env["data"], True)
    jm = _one_round(env, "rush_hour", rule, js)
    assert int(jm.n_selected) > 0


def test_streamed_fedbuff_round_that_drains_and_parks(streamed_env):
    env = streamed_env
    jscn = env["scn"]["rush_hour"][0]
    state = env["state"]
    for _ in range(10):
        prev = state
        state, m = env["jstep"](prev, jscn, jnp.int32(0), jnp.int32(FEDBUFF_IDX),
                                env["data"], True)
        if int(m.n_drained) > 0 and int(m.n_buffered) > 0:
            break
    assert int(m.n_drained) > 0 and int(m.n_buffered) > 0, "no drain-and-park round"
    _one_round(env, "rush_hour", FEDBUFF_IDX, prev)


@pytest.fixture(scope="module")
def wide_env():
    """The streamed lane (K = 7 in chunks of 3, CR 0.7) on the 10 km ring with
    an RSU every 250 m: R = 40."""
    env = _env(20, ("ring",), traffic_kw=dict(rsu_spacing_m=250.0), connection_rate=0.7,
               select_fraction=0.35, client_block=3)
    assert env["scn"]["ring"][1].n_rsu == 40
    return env


@pytest.mark.parametrize("rule", [0, FEDBUFF_IDX])
def test_streamed_round_with_40_rsus_matches_the_jax_round(wide_env, rule):
    """No catalog scenario has more than 10 RSUs; this one has 40, so the
    per-RSU partials span two of the card kernel's RSU groups."""
    env = wide_env
    jscn = env["scn"]["ring"][0]
    js, _ = env["jstep"](env["state"], jscn, jnp.int32(0), jnp.int32(rule), env["data"], True)
    jm = _one_round(env, "ring", rule, js)
    assert int(jm.n_selected) > 0


# ---------------------------------------------------------------------------
# the port's own lanes against each other, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_lanes():
    """Port (state, data, scn) on ring, N=20, CR 0.7, and the full-registry
    steps of the flat, hierarchical and streamed (K=7, B=3) lanes."""
    from repro_torch.utils import prng
    from repro_torch.utils.pytree import tree_bytes as tree_bytes_t

    _, tapi = small_models()
    base = small_fl_kwargs(20, connection_rate=0.7, select_fraction=0.35, buffer_fill=1)
    lanes = {"flat": {}, "hier": dict(hierarchical=True),
             "streamed": dict(hierarchical=True, client_block=3)}
    steps = {name: rounds.make_round_step(
        tapi.loss, FLConfig(**base, **kw), 7, float(tree_bytes_t(tapi.spec)), tapi.spec,
        ("contextual",), aggregators=AGGREGATOR_ORDER) for name, kw in lanes.items()}
    fl = FLConfig(**base)
    scn = scenario_params(scenario_config("ring", num_vehicles=20))
    state, regions = rounds.init_state(tapi, fl, scn, "mnist", "contextual", prng.key(0),
                                       "cpu")
    data = rounds.make_round_data(state.key, "mnist", fl, regions, "cpu")
    return state, data, scn, steps


_ECONOMICS = ("round", "sim_time", "duration", "n_selected", "n_succeeded", "n_buffered",
              "n_drained", "mean_pred_latency", "mean_real_latency")


@pytest.mark.parametrize("rule", RULES)
def test_hierarchical_lane_is_the_flat_lane_bitwise(port_lanes, rule):
    """Contract (a): every RSU of the ring is live and the sample counts are
    integers, so the two-tier weights are the flat ones and the round is
    the flat round, every state leaf and metric, over two rounds."""
    state, data, scn, steps = port_lanes
    for _ in range(2):
        s_f, m_f = steps["flat"](state, scn, 0, rule, data, True)
        s_h, m_h = steps["hier"](state, scn, 0, rule, data, True)
        for f in rounds.RoundState._fields:
            x, y = getattr(s_f, f), getattr(s_h, f)
            same = (all(torch.equal(p, q) for p, q in zip(x, y)) if f == "twin" else
                    torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y)
            assert same, f
        for f in rounds.RoundMetrics._fields:
            x, y = getattr(m_f, f), getattr(m_h, f)
            assert torch.equal(x, y) or bool(torch.isnan(x) & torch.isnan(y)), f
        state = s_f


@pytest.mark.parametrize("rule", RULES)
def test_streamed_lane_keeps_the_economics_of_the_unblocked_lane(port_lanes, rule):
    """The streamed lane reassociates the cohort sum per RSU: the economics,
    the reporting cohort and the ring's occupancy stay bit for bit, the
    model within 1e-6 after two rounds."""
    state, data, scn, steps = port_lanes
    s_h = s_b = state
    for _ in range(2):
        s_h, m_h = steps["hier"](s_h, scn, 0, rule, data, False)
        s_b, m_b = steps["streamed"](s_b, scn, 0, rule, data, False)
        for f in _ECONOMICS:
            assert torch.equal(getattr(m_h, f), getattr(m_b, f)), f
        for f in ("sketch_age", "clusters", "buf_mask", "buf_arrive", "buf_weight"):
            assert torch.equal(getattr(s_h, f), getattr(s_b, f)), f
    for f in ("params", "opt_m", "buf_delta"):
        torch.testing.assert_close(getattr(s_b, f), getattr(s_h, f), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the lane's refusals
# ---------------------------------------------------------------------------
def test_client_block_errors_match_the_jax_package():
    api, tapi = small_models()
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    from repro.config import FLConfig as JFLConfig

    for kw in (dict(client_block=-1, hierarchical=True), dict(client_block=4)):
        with pytest.raises(ValueError) as want:
            jmake_round_step(api.loss, JFLConfig(**small_fl_kwargs(**kw)), 2, 1.0,
                             flat_spec_of(spec_tree), ("contextual",))
        with pytest.raises(ValueError) as got:
            rounds.make_round_step(tapi.loss, FLConfig(**small_fl_kwargs(**kw)), 2, 1.0,
                                   tapi.spec, ("contextual",))
        assert str(got.value) == str(want.value)
    # the bf16 streamed lane runs: bf16 rows into bf16 chunk partials, the
    # economics bit for bit those of the unblocked bf16 two-tier round from
    # the same state
    from repro_torch.utils import prng

    bf16 = dataclasses.replace(FLConfig(**small_fl_kwargs(hierarchical=True, client_block=4)),
                               compute_dtype="bfloat16")
    scn = scenario_params(scenario_config("ring", num_vehicles=20))
    state, regions = rounds.init_state(tapi, bf16, scn, "mnist", "contextual", prng.key(0),
                                       "cpu")
    data = rounds.make_round_data(state.key, "mnist", bf16, regions, "cpu")
    streamed, unblocked = (rounds.make_round_step(
        tapi.loss, dataclasses.replace(bf16, client_block=b), 2, 636_040.0, tapi.spec,
        ("contextual",)) for b in (4, 0))
    (s_b, m_b), (s_u, m_u) = (step(state, scn, 0, 0, data, True)
                              for step in (streamed, unblocked))
    assert s_b.buf_delta.dtype == torch.bfloat16 and s_b.params.dtype == torch.float32
    for f in _ECONOMICS:
        assert torch.equal(getattr(m_b, f), getattr(m_u, f)), f
    assert torch.equal(s_b.sketch_age, s_u.sketch_age)
    torch.testing.assert_close(s_b.params, s_u.params, rtol=0, atol=1e-6)
