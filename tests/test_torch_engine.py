"""The port's experiment engine against the JAX package's, lane for lane.

One reference ``run_grid`` and one port ``run_grid`` of the same 16-lane
grid (strategies ``("contextual", "greedy")`` x aggregators ``("fedavg",
"fedbuff")`` x seeds ``(0, 1)`` x scenarios ``("ring", "platoon")``; the MLP
of ``tests/test_engine.py``, N = 12, CR 0.7, ``recluster_every`` 2, 3
rounds, ``eval_every`` 2) are computed once per module.  The grid takes
the greedy-set cohort width (K = N in every lane), the fedbuff-routed
registry (every lane through the buffered server step), the platoon's own
data row, NaN metrics on the rounds without eval and the recluster
schedule.  Tolerance: ``round``, ``n_selected``, ``n_succeeded``,
``n_buffered`` and ``n_drained`` equal; floats within rtol 2e-4, atol
1e-5 (the reference's own scan-vs-loop tolerance, ``tests/test_engine.py``);
NaN exactly where the reference has NaN.

The helpers are held exactly: ``stack_scenarios`` (fp32 bits),
``data_signature``, ``experiment_key``'s words and ``derive_regions``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrafficConfig as JTrafficConfig
from repro.core import scenarios as jscenarios
from repro.fl import rounds as jrounds
from repro.fl.engine import ExperimentEngine as JEngine
from repro.fl.engine import GridResult as JGridResult
from repro_torch.config import FLConfig, ModelConfig, TrafficConfig
from repro_torch.core import scenarios
from repro_torch.fl import ExperimentEngine, GridResult, rounds
from test_torch_bridge import _one_thread  # noqa: F401

MLP = dict(name="mlp", family="mlp", num_layers=0, d_model=0, num_heads=0, num_kv_heads=0,
           d_ff=48, vocab_size=0, image_shape=(28, 28, 1), num_classes=10, channels=())
FL = dict(num_clients=12, samples_per_client=64, local_epochs=1, num_clusters=4,
          batch_size=32, recluster_every=2, connection_rate=0.7)
ENGINE = dict(strategies=("contextual", "greedy"), aggregators=("fedavg", "fedbuff"))
GRID = dict(seeds=(0, 1), scenarios=("ring", "platoon"), rounds=3, eval_every=2)
N = FL["num_clients"]
INTS = ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained")
RTOL, ATOL = 2e-4, 1e-5
CATALOG = sorted(scenarios.SCENARIOS)


def assert_lane_matches(got, ref, what):
    """One lane's (rounds,) metrics: integers equal, floats within
    (RTOL, ATOL), NaN where the reference has NaN."""
    for f in got._fields:
        a = getattr(got, f).cpu().numpy()
        b = np.asarray(getattr(ref, f))
        if f in INTS:
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {f}")
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f"{what}: {f} NaNs")
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"{what}: {f}")


@pytest.fixture(scope="module")
def grids():
    """(port engine, port result, reference result) of the 16-lane grid."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist", **ENGINE).run_grid(**GRID)
        ref = jax.tree_util.tree_map(np.asarray, ref.metrics), ref.runs
        eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                               **ENGINE)
        return eng, eng.run_grid(**GRID), ref
    finally:
        torch.set_num_threads(prev)


# ---- the helpers -------------------------------------------------------------

def test_stack_scenarios_matches_the_reference_bitwise():
    cfgs = [scenarios.scenario_config(n, num_vehicles=N) for n in CATALOG]
    lifted = [scenarios.scenario_params(c) for c in cfgs]
    got = scenarios.stack_scenarios(lifted)
    ref = jscenarios.stack_scenarios(
        [jscenarios.scenario_params(jscenarios.scenario_config(n, num_vehicles=N))
         for n in CATALOG])
    for f in jscenarios._TRACED_FIELDS:
        a = getattr(got, f).numpy()
        assert a.shape == (len(CATALOG),) and a.dtype == np.float32, f
        np.testing.assert_array_equal(a.view(np.uint32), np.asarray(getattr(ref, f)).view(np.uint32),
                                      err_msg=f)
    for f in jscenarios._STATIC_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    # the port's derived fields stack too, and each lane is its own lift
    for g, one in enumerate(lifted):
        lane = scenarios.scenario_lane(got, g)
        for f in scenarios._LANE_FIELDS:
            x, y = getattr(lane, f), getattr(one, f)
            assert x.shape == () and torch.equal(x, y), (CATALOG[g], f)


def test_stack_scenarios_refuses_mismatched_statics_and_the_traffic_view():
    a = scenarios.scenario_params(scenarios.scenario_config("ring", num_vehicles=N))
    for other in (scenarios.scenario_config("ring", num_vehicles=N + 1),
                  scenarios.scenario_config("platoon", num_vehicles=N, platoon_size=3)):
        with pytest.raises(ValueError, match="static fields"):
            scenarios.stack_scenarios([a, scenarios.scenario_params(other)])
    view = scenarios.traffic_params(scenarios.scenario_config("ring", num_vehicles=N))
    with pytest.raises(ValueError, match="traffic_params"):
        scenarios.stack_scenarios([a, view])


@pytest.mark.parametrize("name", CATALOG)
def test_data_signature_matches_the_reference(name):
    got = scenarios.data_signature(scenarios.scenario_config(name, num_vehicles=N))
    ref = jscenarios.data_signature(jscenarios.scenario_config(name, num_vehicles=N))
    assert got == ref
    assert (got != ()) == (name == "platoon")


def test_data_signature_of_custom_platoons():
    for kw in (dict(platoon_coupling=0.5, platoon_gap_m=25.0), dict(platoon_coupling=0.0),
               dict(platoon_coupling=0.8, platoon_size=3, ring_length_m=9_000.0)):
        got = scenarios.data_signature(TrafficConfig(num_vehicles=N, **kw))
        ref = jscenarios.data_signature(JTrafficConfig(num_vehicles=N, **kw))
        assert got == ref, kw


@pytest.mark.parametrize("dataset,strategy,seed", [
    ("mnist", "contextual", 0), ("mnist", "greedy", 1), ("cifar10", "gossip", 7),
    ("svhn", "network", 123_457)])
def test_experiment_key_matches_the_reference(dataset, strategy, seed):
    got = rounds.experiment_key(dataset, strategy, seed)
    ref = jax.random.key_data(jrounds.experiment_key(dataset, strategy, seed))
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


@pytest.mark.parametrize("name", CATALOG)
def test_derive_regions_matches_the_reference(name):
    for strategy, seed in (("contextual", 0), ("greedy", 3)):
        key = rounds.experiment_key("mnist", strategy, seed)
        jkey = jrounds.experiment_key("mnist", strategy, seed)
        got = rounds.derive_regions(
            key, scenarios.scenario_params(scenarios.scenario_config(name, num_vehicles=N)))
        ref = jrounds.derive_regions(
            jkey, jscenarios.scenario_params(jscenarios.scenario_config(name, num_vehicles=N)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=name)


def test_init_state_folds_as_experiment_key():
    """``init_state`` (FLSimulation's) and the engine's lanes start alike."""
    from repro_torch.models import build_model
    from repro_torch.utils import prng

    api = build_model(ModelConfig(**MLP))
    fl = FLConfig(**FL)
    scn = scenarios.scenario_params(scenarios.scenario_config("platoon", num_vehicles=N))
    a, ra = rounds.init_state(api, fl, scn, "mnist", "gossip", prng.key(4), "cpu")
    b, rb = rounds.init_state_for_key(api, fl, scn, rounds.experiment_key("mnist", "gossip", 4),
                                      "cpu")
    assert torch.equal(a.key, b.key) and torch.equal(a.params, b.params)
    assert torch.equal(ra, rb) and torch.equal(ra, rounds.derive_regions(a.key, scn))


# ---- the 16-lane grid, lane for lane -------------------------------------------

def test_grid_runs_in_the_reference_order(grids):
    _, res, (_, ref_runs) = grids
    assert res.runs == [tuple(r) for r in ref_runs]
    assert len(res.runs) == 16
    for f in res.metrics._fields:
        assert getattr(res.metrics, f).shape == (16, GRID["rounds"]), f


@pytest.mark.parametrize("g", range(16))
def test_grid_lane_matches_the_reference(grids, g):
    _, res, (ref, ref_runs) = grids
    assert_lane_matches(type(res.metrics)(*[x[g] for x in res.metrics]),
                        type(ref)(*[x[g] for x in ref]), str(ref_runs[g]))


def test_grid_exercises_the_ring_the_cohort_and_the_eval_schedule(grids):
    eng, res, (ref, ref_runs) = grids
    m = res.metrics
    assert eng.cohort_size == N  # greedy in the engine: every lane trains N slots
    # some lane parks a straggler and some lane drains (fedbuff lanes only)
    fedbuff = torch.tensor([r[1] == "fedbuff" for r in res.runs])
    assert int(m.n_buffered[fedbuff].sum()) > 0 and int(m.n_drained[fedbuff].sum()) > 0
    assert int(m.n_buffered[~fedbuff].sum()) == int(m.n_drained[~fedbuff].sum()) == 0
    # no eval on round 1 (eval_every 2), eval on round 2 and the last
    acc = m.test_acc
    assert bool(torch.isnan(acc[:, 0]).all()) and bool(torch.isfinite(acc[:, 1:]).all())
    final = res.final_accuracy()
    assert list(final) == res.runs
    for run, a in zip(ref_runs, ref.test_acc[:, -1]):
        assert abs(final[tuple(run)] - float(a)) <= ATOL + RTOL * abs(float(a)), run


def test_records_lookups(grids):
    _, res, _ = grids
    recs = res.records("greedy", 1, "platoon", aggregator="fedbuff")
    assert [r.round for r in recs] == [1, 2, 3]
    g = res.index_of("greedy", 1, "platoon", aggregator="fedbuff")
    assert recs[-1].test_acc == float(res.metrics.test_acc[g, -1])
    with pytest.raises(ValueError, match="pass aggregator= explicitly"):
        res.records("greedy", 1, "platoon")


def test_run_single_is_its_grid_row_bitwise(grids):
    eng, res, _ = grids
    single = eng.run_single("greedy", 1, "platoon", rounds=GRID["rounds"],
                            eval_every=GRID["eval_every"], aggregator="fedbuff")
    row = res.records("greedy", 1, "platoon", aggregator="fedbuff")
    assert len(single) == len(row) == GRID["rounds"]
    for a, b in zip(single, row):
        for f, x in a.__dict__.items():
            y = getattr(b, f)
            assert x == y or (np.isnan(x) and np.isnan(y)), (f, x, y)


# ---- the reference's error paths -----------------------------------------------

def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_error_paths_match_the_reference():
    port = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                            **ENGINE)
    ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist", **ENGINE)
    for kw in (dict(strategies=("gossip",)), dict(aggregators=("fedadam",)),
               dict(scenarios=(TrafficConfig(num_vehicles=N + 1),))):
        call = dict(seeds=(0,), scenarios=("ring",), rounds=1)
        call.update(kw)
        jcall = dict(call)
        if "scenarios" in kw:
            jcall["scenarios"] = (JTrafficConfig(num_vehicles=N + 1),)
        assert _raised(lambda: port.run_grid(**call)) == _raised(lambda: ref.run_grid(**jcall))
    wide = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", device="cpu",
                            num_clients=N + 1)
    jwide = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist", num_clients=N + 1)
    assert wide.fl.num_clients == N + 1
    assert _raised(lambda: wide._traffic_of(TrafficConfig(num_vehicles=N))) == \
        _raised(lambda: jwide._traffic_of(JTrafficConfig(num_vehicles=N)))
    assert _raised(lambda: ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist",
                                            device="cpu", aggregators=("fedprox",))) == \
        _raised(lambda: JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist",
                                aggregators=("fedprox",)))
    runs = [("contextual", "fedavg", 0, "ring"), ("contextual", "fedbuff", 0, "ring")]
    assert _raised(lambda: GridResult(None, runs).index_of("contextual", 0, "ring")) == \
        _raised(lambda: JGridResult(None, runs).index_of("contextual", 0, "ring"))
