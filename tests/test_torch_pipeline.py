"""The paper's four-stage pipeline, called stage by stage, against the JAX package.

The port's RTTG API (``build_rttg``, ``fuse_messages``, ``predict_rttg``,
``connectivity``, ``latency_model``), ``select_clients``,
``update_sketch``, the twin's Euler path (``advance_twin(num_substeps=0)``,
``TrafficTwin``), ``ContextualSelector`` and the pytree FedAvg forms, each
against its JAX counterpart on the same inputs (made from a seed with
numpy, or drawn from the same key).  The reference's core forms take
either a ``TrafficConfig`` of Python floats (as its selector passes it) or
a ``ScenarioParams`` of float32 tensors (as its round passes it); the port
lifts the first with ``traffic_params`` and the second with
``scenario_params``, and each is compared under both.  Integers and booleans must
match exactly (RSU ids, loads, adjacency, connectivity, masks, clusters,
elected ids); floats within the tolerances below.  A discrete stage starts
from the JAX stage's own inputs, converted through numpy, so an ulp
upstream cannot flip a label downstream.  The quickstart and the unfused
round lane are in ``test_torch_pipeline_e2e.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.core import __all__ as JCORE_ALL
from repro.core import clustering as jcl
from repro.core import fusion as jfu
from repro.core import messages as jmsg
from repro.core import network as jnet
from repro.core import pipeline as jpipe
from repro.core import rttg as jrttg
from repro.core import scenarios as jsc
from repro.core import selection as jsel
from repro.core import trajectory as jtraj
from repro.core import twin as jtw
from repro.fl import server as jserver
from repro_torch import core
from repro_torch.config import FLConfig
from repro_torch.core import (clustering, fusion, network, rttg, scenarios, selection,
                              trajectory, twin)
from repro_torch.fl import server
from repro_torch.utils import prng
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

N = 20
# (rtol, atol) per float field.  XLA contracts multiply-adds into FMAs and
# rounds transcendentals differently from torch: a few ulps per op.
# Positions are ~1e4 m, where an ulp is ~1e-3 m.
TOL = {"pos": (1e-6, 1e-2), "speed": (1e-5, 1e-5), "accel": (1e-5, 1e-5),
       "pos_var": (1e-5, 1e-6), "rsu_dist": (1e-5, 1e-3), "t": (1e-6, 1e-6),
       "latency": (1e-5, 1e-6)}
KINDS = ["traffic_config", "scenario_params"]


def tkey(jk):
    return prng.wrap_key_data(np.asarray(jax.random.key_data(jk)))


def cfg_pair(kind, name="ring", n=N):
    """(JAX cfg, port cfg): a ``TrafficConfig`` and its ``traffic_params``,
    or both ``ScenarioParams``."""
    jt = jsc.scenario_config(name, num_vehicles=n)
    tt = scenarios.scenario_config(name, num_vehicles=n)
    if kind == "traffic_config":
        return jt, scenarios.traffic_params(tt)
    return jsc.scenario_params(jt), scenarios.scenario_params(tt)


def t_(x):
    return torch.from_numpy(np.array(x))


def twin_to_torch(state):
    return twin.TwinState(*[t_(x) for x in state])


def rttg_to_torch(r):
    return rttg.RTTG(*[t_(x) for x in r])


def kinematics(name, seed, n=N):
    rng = np.random.default_rng(seed)
    length = scenarios.scenario_config(name, num_vehicles=n).ring_length_m
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(rng.uniform(0.0, length, n)), f32(14.0 + 4.0 * rng.standard_normal(n)),
            f32(0.3 * rng.standard_normal(n)), f32(rng.uniform(0.1, 4.0, n)))


def both_rttgs(kind, name, seed, t=12.5):
    jcfg, tcfg = cfg_pair(kind, name)
    k = kinematics(name, seed)
    ref = jrttg.build_rttg(jnp.float32(t), *map(jnp.asarray, k), jcfg)
    got = rttg.build_rttg(torch.tensor(t), *map(torch.from_numpy, k), tcfg)
    return jcfg, tcfg, ref, got


def assert_rttg_matches(got, ref):
    for f in ("rsu_id", "load", "adj"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("t", "pos", "speed", "accel", "pos_var", "rsu_dist"):
        rtol, atol = TOL[f]
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


def test_core_exports_the_jax_core_names_but_the_grid_engines():
    assert set(core.__all__) == set(JCORE_ALL) - {"stack_scenarios"}
    assert rttg.V2V_RANGE_M == jrttg.V2V_RANGE_M


@pytest.mark.parametrize("name", ["ring", "rsu_outage", "rush_hour"])
@pytest.mark.parametrize("kind", KINDS)
def test_build_rttg_matches_with_its_adjacency(kind, name):
    _, _, ref, got = both_rttgs(kind, name, seed=1)
    assert got.adj.shape == (N, N) and got.adj.dtype == torch.bool
    assert got.adj.any() and not got.adj.all()
    assert_rttg_matches(got, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_fuse_messages_matches(kind):
    jcfg, tcfg = cfg_pair(kind)
    st = jax.jit(lambda k: jtw.init_twin_state(jsc.scenario_params(
        jsc.scenario_config("ring", num_vehicles=N)), k))(jax.random.key(2))
    st = st._replace(t=jnp.float32(31.5))
    jk = jax.random.key(3)
    cams, cpms = jmsg.emit_cams(st, jcfg, jk), jmsg.emit_cpms(st, jcfg, jk)
    ref = jfu.fuse_messages(cams, cpms, st.t, jcfg)
    to_t = lambda d: {k: t_(v) for k, v in d.items()}
    got = fusion.fuse_messages(to_t(cams), to_t(cpms), t_(st.t), tcfg)
    assert_rttg_matches(got, ref)


@pytest.mark.parametrize("horizon", [0.0, 1.0, 5.0])
@pytest.mark.parametrize("kind", KINDS)
def test_predict_rttg_matches(kind, horizon):
    jcfg, tcfg, jr, _ = both_rttgs(kind, "ring", seed=4)
    ref = jtraj.predict_rttg(jr, horizon, jcfg)
    got = trajectory.predict_rttg(rttg_to_torch(jr), horizon, tcfg)
    assert_rttg_matches(got, ref)
    # the variance inflation pos_var + accel_std^2 h^3 / 3: Python doubles
    # under a TrafficConfig, float32 under ScenarioParams, on both sides
    np.testing.assert_array_equal(got.pos_var.numpy(), np.asarray(ref.pos_var))


@pytest.mark.parametrize("cr", [1.0, 0.7])
@pytest.mark.parametrize("kind", KINDS)
def test_connectivity_matches(kind, cr):
    jcfg, tcfg, jr, _ = both_rttgs(kind, "rsu_outage", seed=5)
    jk = jax.random.key(6)
    ref = jnet.connectivity(jr, jcfg, cr, jk)
    got = network.connectivity(rttg_to_torch(jr), tcfg, cr, tkey(jk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.all() or cr == 1.0
    if cr < 1.0:
        with pytest.raises(ValueError, match="PRNG key"):
            network.connectivity(rttg_to_torch(jr), tcfg, cr)
    np.testing.assert_allclose(network.snr_db(rttg_to_torch(jr), tcfg).numpy(),
                               np.asarray(jnet.snr_db(jr, jcfg)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", ["ring", "rush_hour", "day_cycle"])
@pytest.mark.parametrize("kind", KINDS)
def test_latency_model_matches(kind, name):
    jcfg, tcfg, jr, _ = both_rttgs(kind, name, seed=7, t=250.0)
    ref = jnet.latency_model(jr, 636_040, jcfg)
    got = network.latency_model(rttg_to_torch(jr), 636_040, tcfg)
    rtol, atol = TOL["latency"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def _selection_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.random(N) < 0.8, np.round(rng.uniform(0.05, 2.0, N), 1).astype(np.float32),
            rng.integers(0, 3, N).astype(np.int32))


@pytest.mark.parametrize("strategy", sorted(jsel.STRATEGIES))
def test_select_clients_matches(strategy):
    conn, lat, clusters = _selection_inputs(8)
    jk = jax.random.key(9)
    ref = jsel.select_clients(strategy, jk, jnp.asarray(conn), jnp.asarray(lat),
                              jnp.asarray(clusters), 5, 0.3)
    got = selection.select_clients(strategy, tkey(jk), torch.from_numpy(conn),
                                   torch.from_numpy(lat),
                                   torch.from_numpy(clusters.astype(np.int64)), 5, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_select_clients_refuses_an_unknown_strategy_with_the_same_message():
    args = (None, None, None, 1, 0.1)
    with pytest.raises(KeyError) as ref:
        jsel.select_clients("nope", None, *args)
    with pytest.raises(KeyError) as got:
        selection.select_clients("nope", None, *args)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("batch", [False, True])
def test_update_sketch_matches(batch):
    jk = jax.random.key(10)
    v = np.random.default_rng(11).standard_normal((3, 5000)).astype(np.float32)
    if batch:
        ref = jax.vmap(lambda u: jcl.update_sketch(u, jk, 256))(jnp.asarray(v))
        got = clustering.update_sketch(torch.from_numpy(v), tkey(jk), 256)
    else:
        ref = jcl.update_sketch(jnp.asarray(v[0]), jk, 256)
        got = clustering.update_sketch(torch.from_numpy(v[0]), tkey(jk), 256)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6)


# the twin over 10 s of 100 Euler steps: XLA fuses each step into FMAs, so
# positions (~1e4 m) drift apart by a few ulps a step
TWIN_TOL = {"t": (1e-6, 1e-6), "pos": (1e-5, 5e-2), "speed": (1e-4, 1e-4),
            "accel": (1e-4, 1e-4)}


@pytest.mark.parametrize("name", ["ring", "rush_hour", "platoon"])
@pytest.mark.parametrize("kind", KINDS)
def test_advance_twin_euler_path_matches(kind, name):
    jcfg, tcfg = cfg_pair(kind, name)
    jk, ka = jax.random.key(12), jax.random.key(13)
    if kind == "traffic_config":  # the TrafficTwin API, init included
        tt = twin.TrafficTwin(scenarios.scenario_config(name, num_vehicles=N), tkey(jk), "cpu")
        jt = jtw.TrafficTwin(jcfg, jk)
        st0 = jt.init_state()
        got0 = tt.init_state()
        np.testing.assert_array_equal(got0.lane.numpy(), np.asarray(st0.lane))
        for f in ("pos", "speed", "compute_factor"):
            np.testing.assert_allclose(getattr(got0, f).numpy(), np.asarray(getattr(st0, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f)
        ref = jt.advance(st0, ka, 10.0)
        got = tt.advance(twin_to_torch(st0), tkey(ka), 10.0)
    else:
        st0 = jax.jit(lambda k: jtw.init_twin_state(jcfg, k))(jk)
        ref = jax.jit(lambda s, k: jtw.advance_twin(s, jcfg, k, jnp.float32(10.0)))(st0, ka)
        got = twin.advance_twin(twin_to_torch(st0), tcfg, tkey(ka), 10.0)
    assert float(got.t) == pytest.approx(10.0, abs=1e-4)
    for f, (rtol, atol) in TWIN_TOL.items():
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


@pytest.mark.parametrize("duration", [0.01, 0.25, 0.35])
def test_advance_twin_step_count_rounds_half_to_even_in_float32(duration):
    """``max(round(duration / sim_dt_s), 1)`` steps: 0.25 / 0.1 rounds to 2."""
    jcfg, tcfg = cfg_pair("traffic_config")
    st0 = jax.jit(lambda k: jtw.init_twin_state(jcfg, k))(jax.random.key(14))
    ref = jtw.advance_twin(st0, jcfg, jax.random.key(15), jnp.float32(duration))
    got = twin.advance_twin(twin_to_torch(st0), tcfg, tkey(jax.random.key(15)), duration)
    np.testing.assert_allclose(float(got.t), float(ref.t), rtol=1e-6)
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(ref.pos), rtol=1e-6, atol=1e-2)


def test_twin_step_matches():
    jcfg, tcfg = cfg_pair("traffic_config", "rush_hour")
    st0 = jax.jit(lambda k: jtw.init_twin_state(jcfg, k))(jax.random.key(16))
    st0 = st0._replace(t=jnp.float32(140.0), accel=jnp.full((N,), 0.5, jnp.float32))
    jk = jax.random.key(17)
    ref = jtw.twin_step(st0, jcfg, jk, 0.1)
    got = twin.twin_step(twin_to_torch(st0), tcfg, tkey(jk), 0.1)
    for f, (rtol, atol) in TWIN_TOL.items():
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=rtol, atol=atol, err_msg=f)


def test_pytree_fedavg_forms_match():
    rng = np.random.default_rng(18)
    params = {"fc1": {"b": rng.standard_normal(5), "w": rng.standard_normal((3, 5))},
              "fc2": {"b": rng.standard_normal(2), "w": rng.standard_normal((5, 2))}}
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    updates = jax.tree_util.tree_map(
        lambda a: 0.01 * rng.standard_normal((4,) + a.shape).astype(np.float32), params)
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    ref = jserver.fedavg_aggregate(params, updates, jnp.asarray(w))
    got = server.fedavg_aggregate(jax.tree_util.tree_map(torch.from_numpy, params),
                                  jax.tree_util.tree_map(torch.from_numpy, updates),
                                  torch.from_numpy(w))
    for path in (("fc1", "b"), ("fc1", "w"), ("fc2", "b"), ("fc2", "w")):
        a, b = got[path[0]][path[1]], ref[path[0]][path[1]]
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---- ContextualSelector, stage by stage --------------------------------------

@pytest.fixture(scope="module")
def selectors():
    """A JAX selector and the port's, in the same state at round 4 (CR 0.7,
    so the forced draw runs): planted clusters of sketches, stale ages."""
    jfl = JFLConfig(num_clients=N, num_clusters=3, sketch_dim=64, connection_rate=0.7,
                    select_fraction=0.25)
    tfl = FLConfig(num_clients=N, num_clusters=3, sketch_dim=64, connection_rate=0.7,
                   select_fraction=0.25)
    jtc, ttc = cfg_pair("traffic_config")[0], scenarios.scenario_config("ring", num_vehicles=N)
    key = jax.random.key(20)
    js = jpipe.ContextualSelector(jfl, jtc, key)
    ts = core.ContextualSelector(tfl, ttc, tkey(key), device="cpu")
    rng = np.random.default_rng(21)
    centers = rng.standard_normal((3, 64))
    x = centers[rng.integers(0, 3, N)] + 0.4 * rng.standard_normal((N, 64))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    age = rng.integers(0, 4, N).astype(np.float32)
    clusters = rng.integers(0, 3, N)
    js.sketches, js.sketch_age = jnp.asarray(x), jnp.asarray(age)
    js.clusters, js._round = jnp.asarray(clusters, jnp.int32), 4
    ts.sketches, ts.sketch_age = torch.from_numpy(x), torch.from_numpy(age)
    ts.clusters, ts._round = torch.from_numpy(clusters), 4
    st = jtw.TrafficTwin(jtc, key)
    twin_state = st.advance(st.init_state(), jax.random.key(22), 30.0)
    return js, ts, twin_state


def test_selector_round_stage_by_stage(selectors):
    js, ts, st = selectors
    mb = 407_080
    # stage 1: fuse the observed messages
    jr = js.observe(st)
    assert_rttg_matches(ts.observe(twin_to_torch(st)), jr)
    # stage 2 from the JAX RTTG: predicted latency and the connected mask
    ts.rttg = rttg_to_torch(jr)
    jlat, jfut = js.predicted_latency(mb)
    tlat, tfut = ts.predicted_latency(mb)
    assert_rttg_matches(tfut, jfut)
    rtol, atol = TOL["latency"]
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ts.connected_mask(rttg_to_torch(jfut)).numpy(),
                                  np.asarray(js.connected_mask(jfut)))
    # stage 4 on every strategy, from the same RTTG and clusters
    for strategy in sorted(jsel.STRATEGIES):
        ref, got = js.select(strategy, mb), ts.select(strategy, mb)
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(ref["mask"]),
                                      err_msg=strategy)
        np.testing.assert_array_equal(got["connected"].numpy(), np.asarray(ref["connected"]))
        np.testing.assert_allclose(got["latency_pred"].numpy(), np.asarray(ref["latency_pred"]),
                                   rtol=rtol, atol=atol)
        assert got["n_select"] == ref["n_select"] == 5
        assert int(got["mask"].sum()) > 0
    # stage 3 in: three clients report
    ids = np.asarray([0, 7, 13])
    vecs = np.random.default_rng(23).standard_normal((3, 300)).astype(np.float32)
    js.report_updates(jnp.asarray(ids), jnp.asarray(vecs))
    ts.report_updates(torch.from_numpy(ids), torch.from_numpy(vecs))
    np.testing.assert_array_equal(ts.sketch_age.numpy(), np.asarray(js.sketch_age))
    np.testing.assert_allclose(ts.sketches.numpy(), np.asarray(js.sketches), rtol=1e-4,
                               atol=1e-6)
    js.report_update(3, jnp.asarray(vecs[1]))
    ts.report_update(3, torch.from_numpy(vecs[1]))
    np.testing.assert_allclose(ts.sketches[3].numpy(), np.asarray(js.sketches[3]), rtol=1e-4,
                               atol=1e-6)
    # stage 3: the round ends (round 5 re-clusters), from the JAX sketches
    ts.sketches = t_(js.sketches)
    js.end_round()
    ts.end_round()
    assert ts._round == js._round == 5
    np.testing.assert_array_equal(ts.sketch_age.numpy(), np.asarray(js.sketch_age))
    np.testing.assert_array_equal(ts.clusters.numpy(), np.asarray(js.clusters))
    assert len(np.unique(np.asarray(js.clusters))) == 3


def test_selector_refuses_a_card_it_does_not_have_and_needs_observe_first():
    tfl = FLConfig(num_clients=N)
    ttc = scenarios.scenario_config("ring", num_vehicles=N)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            core.ContextualSelector(tfl, ttc, prng.key(0))
        with pytest.raises(RuntimeError, match="CUDA"):
            core.TrafficTwin(ttc, prng.key(0))
    sel = core.ContextualSelector(tfl, ttc, prng.key(0), device="cpu")
    with pytest.raises(RuntimeError, match="observe"):
        sel.select("contextual", 1.0)
    with pytest.raises(RuntimeError, match="observe"):
        sel.predicted_latency(1.0)
