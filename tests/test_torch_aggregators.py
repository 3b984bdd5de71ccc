"""The server-optimizer registry of the port against the JAX package.

Inputs come from numpy with a seed and go through both sides.  What is held:

* the registry itself (order, indices, ``ServerHP``, the catalog error);
* ``apply_rule`` against ``repro.fl.aggregators.apply_rule`` for all six
  rules, from the same delta: within 4 ulps of each output's largest value
  (XLA contracts the moment updates' multiply-adds into FMAs; torch rounds
  each op, and the adaptive step's division carries the ulp on);
* ``staleness_scale`` bit for bit, including ``timeout = per_slot = 0``;
* the kernels' plain versions against ``repro.kernels.ref`` at the
  reference's edge shapes, with ``drain`` both ways: the weighted sums run in
  another order on each side, so ``m`` within 1e-6 of ``sum_k |w_k u_k|``
  and ``params`` within 1e-4 of it (the adaptive rules' step
  ``m / (sqrt(v) + tau)`` magnifies a delta's error by up to
  ``(1 - beta1) / tau = 100``);
* the FedProx trainer (``mu`` 0 and 50) against the JAX trainer;
* one whole round from an injected JAX state under the full registry, for
  every aggregator index at CR 1.0 and 0.7: integers exact, floats within
  ``test_torch_bridge.REGISTRY_ROUND_TOL``;
* the ``stale`` all-stragglers round and the CLI over every aggregator.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scenarios import scenario_config as jscenario_config
from repro.core.scenarios import scenario_params as jscenario_params
from repro.fl import aggregators as jagg
from repro.fl.client import make_local_trainer as jmake_local_trainer
from repro.fl.rounds import flat_spec_of
from repro.fl.rounds import make_round_step as jmake_round_step
from repro.kernels import ref as jref
from repro.sharding import split_params
from repro.utils import tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.fl import aggregators as agg
from repro_torch.fl import rounds
from repro_torch.fl.client import make_local_trainer
from repro_torch.kernels import server_update as su_mod
from repro_torch.launch import fl_sim
from repro_torch.utils import prng
from repro_torch.utils.pytree import tree_bytes as tree_bytes_t
from test_torch_bridge import (  # noqa: F401  (_one_thread: autouse fixture)
    _one_thread,
    assert_round_matches,
    data_to_numpy,
    jax_experiment,
    small_fl_kwargs,
    small_models,
    state_to_numpy,
    tree_to_numpy,
)

RULES = range(len(agg.AGGREGATOR_ORDER))
HPS = {"default": agg.ServerHP(), "custom": agg.ServerHP(eta=0.5, beta1=0.8, beta2=0.9,
                                                         tau=1e-2)}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _operands(k, p, seed=0):
    """(updates, weights, params, m, v) as numpy, the reference's value ranges."""
    rng = np.random.default_rng(seed * 7919 + k * 31 + p)
    u = rng.normal(size=(k, p)).astype(np.float32)
    w = rng.random(k).astype(np.float32)
    w /= w.sum()
    params = rng.normal(size=p).astype(np.float32)
    m = (0.1 * rng.normal(size=p)).astype(np.float32)
    v = np.abs(0.01 * rng.normal(size=p)).astype(np.float32)
    return u, w, params, m, v


def test_registry_matches_the_reference():
    assert agg.AGGREGATOR_ORDER == jagg.AGGREGATOR_ORDER
    assert (agg.STALE_IDX, agg.FEDBUFF_IDX) == (jagg.STALE_IDX, jagg.FEDBUFF_IDX)
    assert tuple(agg.ServerHP()) == tuple(jagg.ServerHP())
    fl = FLConfig(server_lr=0.3, server_beta1=0.7, server_beta2=0.95, server_tau=1e-4)
    assert tuple(agg.server_hp(fl)) == (0.3, 0.7, 0.95, 1e-4)
    assert agg.validate_aggregators(("fedavg", "stale")) == ("fedavg", "stale")
    with pytest.raises(ValueError) as ei:
        agg.validate_aggregators(("fedprox",))
    for name in agg.AGGREGATOR_ORDER:
        assert name in str(ei.value)
    su_mod._assert_registry_order()


@pytest.mark.parametrize("hp", HPS, ids=list(HPS))
@pytest.mark.parametrize("rule", RULES)
def test_apply_rule_matches_the_jax_rule(rule, hp):
    hp = HPS[hp]
    _, _, params, m, v = _operands(2, 257, seed=5)
    delta = (0.05 * np.random.default_rng(42).normal(size=257)).astype(np.float32)
    delta[:8] = 0.0  # yogi's sign(0) and the fixed points of every rule
    v[8:16] = delta[8:16] ** 2  # yogi's sign ties
    (jm, jv), jp = jax.jit(lambda *a: jagg.apply_rule(*a[:4], jnp.int32(1), jagg.ServerHP(*hp)))(
        jnp.int32(rule), (jnp.asarray(m), jnp.asarray(v)), jnp.asarray(params),
        jnp.asarray(delta))
    (tm, tv), tp = agg.apply_rule(rule, (_t(m), _t(v)), _t(params), _t(delta), 1, hp)
    for name, a, b in (("params", tp, jp), ("m", tm, jm), ("v", tv, jv)):
        b = np.asarray(b)
        ulp = np.spacing(np.abs(b).max())
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=4 * ulp,
                                   err_msg=f"{agg.AGGREGATOR_ORDER[rule]}/{name}")
    if rule == 3:  # the ties kept v exactly where sign(v - d^2) == 0
        np.testing.assert_array_equal(tv.numpy()[8:16], v[8:16])


def test_staleness_scale_matches_bit_for_bit():
    lat = np.array([0.0, 7.5, 15.0, 150.0, 3.3e-3, 1e6], np.float32)
    for timeout in (15.0, 0.0, 1e-3):
        ref = np.asarray(jagg.staleness_scale(jnp.asarray(lat), jnp.float32(timeout)))
        got = agg.staleness_scale(_t(lat), torch.tensor(timeout)).numpy()
        np.testing.assert_array_equal(got, ref)
        assert np.isfinite(got).all()
    zero = agg.staleness_scale(torch.zeros(3), torch.tensor(0.0))
    assert torch.equal(zero, torch.zeros(3))  # 0/0 guarded to an exact 0 weight


def _assert_server_outputs(got, want, u, w, rule):
    scale = float((np.abs(w) @ np.abs(u)).max())
    for name, a, b, atol in zip(("params", "m", "v"), got, want,
                                (1e-4 * scale, 1e-6 * scale, 1e-6 * scale)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=atol,
                                   err_msg=f"{agg.AGGREGATOR_ORDER[rule]}/{name}")


# the reference's edge shapes (tests/test_aggregators.py): K=1 cohorts, P one
# off either side of a power of two, exact multiples, the engine's hot shape
_EDGE_SHAPES = [(1, 2047), (1, 130000), (5, 2047), (5, 2049), (5, 4096), (3, 130000),
                (2, 8192), (7, 513), (16, 5000), (100, 38656)]
_jref_update = jax.jit(jref.server_update)
_jref_buffered = jax.jit(jref.server_update_buffered)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("k,p", _EDGE_SHAPES)
def test_server_update_plain_matches_ref(k, p, rule):
    u, w, params, m, v = _operands(k, p)
    want = _jref_update(u, w, params, m, v, jnp.int32(rule), jnp.int32(3))
    before = su_mod.launches
    got = su_mod.server_update(_t(u), _t(w), _t(params), _t(m), _t(v), rule, 3)
    assert su_mod.launches == before  # CPU tensors never reach the kernel
    _assert_server_outputs(got, want, u, w, rule)


# the reference's buffered edge shapes (tests/test_fedbuff.py): (K, Kb, P)
_BUF_SHAPES = [(1, 1, 2047), (5, 1, 2050), (5, 8, 2047), (3, 4, 4096), (2, 16, 511),
               (7, 3, 1024)]


@pytest.mark.parametrize("drain", [False, True])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("k,kb,p", _BUF_SHAPES)
def test_server_update_buffered_plain_matches_ref(k, kb, p, rule, drain):
    u, w, params, m, v = _operands(k, p, seed=rule)
    rng = np.random.default_rng(kb * 13 + p)
    buf = rng.normal(size=(kb, p)).astype(np.float32)
    bw = rng.random(kb).astype(np.float32)
    want = _jref_buffered(u, w, buf, bw, params, m, v, jnp.int32(rule), jnp.int32(3),
                          jnp.asarray(drain))
    before = su_mod.buffered_launches
    got = su_mod.server_update_buffered(_t(u), _t(w), _t(buf), _t(bw), _t(params), _t(m),
                                        _t(v), rule, 3, torch.tensor(drain))
    assert su_mod.buffered_launches == before
    rows = np.concatenate([u, buf]) if drain else u
    weights = np.concatenate([w, bw]) if drain else w
    _assert_server_outputs(got, want, rows, weights, rule)


@pytest.mark.parametrize("rule", RULES)
def test_plain_contracts_a_and_b(rule):
    """(a) rule 0 is ``fedavg_reduce`` + ``apply_delta_flat``, bit for bit on
    the CPU (the plain versions share their sum); (b) the buffered form with
    ``drain`` false equals the unbuffered one.  (b)'s plain version sums
    K + Kb rows in one einsum, which the CPU's BLAS blocks otherwise than
    K rows, so on the CPU it holds within the tolerances of the
    plain-vs-reference checks above (bit for bit on the card, where the
    kernel walks the rows in a fixed order: ``tests/test_torch_gpu.py``)."""
    from repro_torch.fl.server import apply_delta_flat
    from repro_torch.kernels.fedavg_reduce import fedavg_reduce

    u, w, params, m, v = (_t(x) for x in _operands(5, 2049, seed=rule + 100))
    got = su_mod.server_update(u, w, params, m, v, rule, 0)
    if rule == 0:
        assert torch.equal(got[0], apply_delta_flat(params, fedavg_reduce(u, w)))
        assert torch.equal(got[1], m) and torch.equal(got[2], v)
    buf = torch.from_numpy(np.random.default_rng(rule).normal(size=(8, 2049)).astype(np.float32))
    off = su_mod.server_update_buffered(u, w, buf, torch.rand(8), params, m, v, rule, 0,
                                        torch.tensor(False))
    _assert_server_outputs(off, [x.numpy() for x in got], u.numpy(), w.numpy(), rule)


def test_wrappers_reject_devices_they_do_not_serve():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        su_mod.server_update(torch.zeros((2, 4), device="meta"), x[:2], x, x, x, 0, 0)
    with pytest.raises(ValueError):
        su_mod.server_update_buffered(torch.zeros((2, 4), device="meta"), x[:2],
                                      torch.zeros((1, 4), device="meta"), x[:1], x, x, x,
                                      5, 0, torch.tensor(True, device="meta"))


@pytest.mark.parametrize("mu", [0.0, 50.0])
def test_fedprox_trainer_matches_jax(mu):
    """The proximal term ``mu * (p - p_global)`` on both sides; ``mu = 0``
    is the plain trainer.  Updates within 1e-3 relative / 1e-4 of the
    largest (the gradients sum in another order; see test_torch_model)."""
    api, tapi = small_models(32)
    tree = split_params(api.init(jax.random.key(6)))[0]
    K, n, bs = 3, 32, 16
    rng = np.random.default_rng(7)
    images = rng.normal(size=(K, n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, (K, n)).astype(np.int32)
    jk = jax.random.key(7)
    _, ref = jmake_local_trainer(api.loss, 1e-3, 2, bs, mu=mu)(
        tree, jnp.asarray(images), jnp.asarray(labels), jk)
    _, got = make_local_trainer(tapi.loss, 1e-3, 2, bs, mu=mu)(
        convert.params_tree_from_numpy(tree_to_numpy(tree)), torch.from_numpy(images),
        torch.from_numpy(labels.astype(np.int64)),
        prng.wrap_key_data(np.asarray(jax.random.key_data(jk))))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max())
    if mu:
        _, plain = make_local_trainer(tapi.loss, 1e-3, 2, bs)(
            convert.params_tree_from_numpy(tree_to_numpy(tree)), torch.from_numpy(images),
            torch.from_numpy(labels.astype(np.int64)),
            prng.wrap_key_data(np.asarray(jax.random.key_data(jk))))
        assert (got.norm(dim=1) < plain.norm(dim=1)).all()  # the pull toward p_global


# ---------------------------------------------------------------------------
# one whole round from an injected JAX state, every aggregator index
# ---------------------------------------------------------------------------
N = 20


@pytest.fixture(scope="module", params=[1.0, 0.7], ids=["cr1.0", "cr0.7"])
def registry_env(request):
    """Both sides' full-registry round programs (one JAX compile per CR)."""
    cr = request.param
    state, data, fl, api = jax_experiment(connection_rate=cr)
    state = state._replace(round=jnp.int32(4))  # new_round 5: re-cluster
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    jstep = jax.jit(jmake_round_step(api.loss, fl, fl.n_select, mb, flat_spec_of(spec_tree),
                                     ("contextual",), aggregators=jagg.AGGREGATOR_ORDER))
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(N, connection_rate=cr))
    tstep = rounds.make_round_step(tapi.loss, tfl, tfl.n_select, mb, tapi.spec,
                                   ("contextual",), aggregators=agg.AGGREGATOR_ORDER)
    return dict(state=state, data=data, jstep=jstep, tstep=tstep,
                jscn=jscenario_params(jscenario_config("ring", num_vehicles=N)),
                scn=scenario_params(scenario_config("ring", num_vehicles=N)))


@pytest.mark.parametrize("rule", RULES)
def test_one_registry_round_matches_the_jax_round(registry_env, rule):
    """The state after one JAX round of this rule (moments and ring no longer
    zero) goes into both sides for a second round."""
    env = registry_env
    zero, ai = jnp.int32(0), jnp.int32(rule)
    js, _ = env["jstep"](env["state"], env["jscn"], zero, ai, env["data"], True)
    js2, jm2 = env["jstep"](js, env["jscn"], zero, ai, env["data"], True)
    ts = convert.state_from_numpy(state_to_numpy(js))
    td = convert.data_from_numpy(data_to_numpy(env["data"]))
    ts2, tm2 = env["tstep"](ts, env["scn"], 0, rule, td, True)
    assert_round_matches(tm2, ts2, jm2, js2)
    if rule in (2, 3):
        assert np.abs(np.asarray(js2.opt_v)).max() > 0  # the moments moved


def test_stale_all_stragglers_round_still_updates():
    """CR 0.05 on rush_hour: in a round where every selected client misses
    the deadline, ``stale`` still moves the model (its discounted update),
    while the ``("fedavg",)`` round from the same state leaves it put."""
    _, tapi = small_models()
    n = 10
    fl = FLConfig(**small_fl_kwargs(n, samples_per_client=32, batch_size=16,
                                    connection_rate=0.05))
    scn = scenario_params(scenario_config("rush_hour", num_vehicles=n))
    state, regions = rounds.init_state(tapi, fl, scn, "mnist", "contextual",
                                       prng.key(0), "cpu")
    data = rounds.make_round_data(state.key, "mnist", fl, regions, "cpu")
    mb = float(tree_bytes_t(tapi.spec))
    step = rounds.make_round_step(tapi.loss, fl, fl.n_select, mb, tapi.spec,
                                  ("contextual",), aggregators=agg.AGGREGATOR_ORDER)
    legacy = rounds.make_round_step(tapi.loss, fl, fl.n_select, mb, tapi.spec,
                                    ("contextual",))
    found = False
    for _ in range(12):
        prev = state
        state, m = step(state, scn, 0, agg.STALE_IDX, data, False)
        assert torch.isfinite(state.params).all()
        if int(m.n_selected) > 0 and int(m.n_succeeded) == 0:
            found = True
            assert not torch.equal(state.params, prev.params)
            assert np.isfinite([float(m.duration), float(m.mean_real_latency)]).all()
            s_l, m_l = legacy(prev, scn, 0, 0, data, False)
            assert int(m_l.n_succeeded) == 0 and torch.equal(s_l.params, prev.params)
    assert found, "no all-stragglers round at CR 0.05"


@pytest.mark.parametrize("aggregator", agg.AGGREGATOR_ORDER)
def test_cli_and_simulation_run_every_aggregator(tmp_path, aggregator):
    out = tmp_path / "run.json"
    fl_sim.main(["--rounds", "1", "--num-clients", "10", "--device", "cpu", "--quiet",
                 "--aggregator", aggregator, "--connection-rate", "0.7", "--out", str(out)])
    result = json.loads(out.read_text())
    assert result["aggregator"] == aggregator and len(result["rounds"]) == 1
    assert np.isfinite(result["rounds"][0]["test_loss"])
