"""The port's ``FLSimulation`` and CLI against the JAX package's.

A 3-round run from the same seed on both sides (N=20 clients, 64 samples,
a 32-unit MLP, ring / contextual / mnist) must end within 0.02 test
accuracy of the JAX run: one round agrees to float tolerance
(``tests/test_torch_round.py``), and the per-round float drift must not
grow into a different model over three rounds.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.core.scenarios import scenario_config as jscenario_config
from repro.fl.simulation import FLSimulation as JFLSimulation
from repro_torch.config import FLConfig
from repro_torch.core.scenarios import scenario_config
from repro_torch.fl.simulation import FLSimulation, time_to_accuracy
from repro_torch.launch import fl_sim
from repro_torch.utils import prng
from repro_torch.utils.pytree import flat_size_of
from test_torch_bridge import _one_thread, small_fl_kwargs, small_models  # noqa: F401

N = 20
ACC_TOL = 0.02


def test_three_rounds_end_at_the_jax_accuracy():
    api, tapi = small_models(32)
    kw = small_fl_kwargs(N, local_epochs=2, batch_size=32)
    ref = JFLSimulation(api.cfg, JFLConfig(**kw), jscenario_config("ring", num_vehicles=N),
                        "mnist", "contextual", jax.random.key(0)).run(3)
    sim = FLSimulation(tapi.cfg, FLConfig(**kw), scenario_config("ring", num_vehicles=N),
                       "mnist", "contextual", prng.key(0), device="cpu")
    got = sim.run(3)
    assert [r.round for r in got] == [1, 2, 3]
    assert abs(got[-1].test_acc - ref[-1].test_acc) <= ACC_TOL, (got[-1], ref[-1])
    assert all(np.isfinite([r.sim_time, r.duration, r.test_loss]).all() for r in got)
    assert sim.state.params.shape == (flat_size_of(tapi.spec),)


def test_initial_state_and_client_shards_match():
    """init_state / make_round_data from the same seed key: integers exact
    (labels, lanes, regions, signs), floats within a few ulps."""
    from repro.fl.rounds import experiment_key, init_state_traced, make_round_data
    from repro.sharding import split_params
    from repro_torch import convert
    from repro_torch.core.scenarios import scenario_params
    from repro_torch.fl import rounds
    from test_torch_bridge import data_to_numpy, state_to_numpy

    api, tapi = small_models(32)
    kw = small_fl_kwargs(N)
    tc = jscenario_config("ring", num_vehicles=N)
    jkey = experiment_key("mnist", "gossip", 3)
    jstate, jregions = jax.jit(lambda k: init_state_traced(
        lambda kk: split_params(api.init(kk))[0], JFLConfig(**kw), tc, k))(jkey)
    jdata = make_round_data(jkey, "mnist", JFLConfig(**kw), jregions)
    scn = scenario_params(scenario_config("ring", num_vehicles=N))
    state, regions = rounds.init_state(tapi, FLConfig(**kw), scn, "mnist", "gossip",
                                       prng.key(3), "cpu")
    data = rounds.make_round_data(state.key, "mnist", FLConfig(**kw), regions, "cpu")
    np.testing.assert_array_equal(regions.numpy(), np.asarray(jregions))
    ref, got = state_to_numpy(jstate), convert.state_to_numpy(state)
    for name in ("key", "sketch_sign", "clusters", "sketch_age", "round"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    np.testing.assert_array_equal(got["twin"]["lane"], ref["twin"]["lane"])
    np.testing.assert_allclose(got["params"], ref["params"], rtol=1e-6, atol=1e-7)
    for f in ("pos", "speed", "compute_factor"):
        np.testing.assert_allclose(got["twin"][f], ref["twin"][f], rtol=1e-5, err_msg=f)
    dref, dgot = data_to_numpy(jdata), convert.data_to_numpy(data)
    for name in ("labels", "test_y", "counts"):
        np.testing.assert_array_equal(dgot[name], dref[name], err_msg=name)
    for name in ("images", "test_x"):
        np.testing.assert_allclose(dgot[name], dref[name], rtol=1e-5, atol=1e-5, err_msg=name)


def test_uniform_class_sets_match_without_regions():
    from repro.fl.partition import partition_labels as jpartition_labels
    from repro_torch.fl.partition import partition_labels

    kw = small_fl_kwargs(N, classes_per_client=3)
    jk = jax.random.key(12)
    ref = jpartition_labels(jk, "mnist", JFLConfig(**kw))
    got = partition_labels(prng.wrap_key_data(np.asarray(jax.random.key_data(jk))),
                           "mnist", FLConfig(**kw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_simulation_without_a_device_argument_needs_a_card():
    """Entry points run on cuda by default and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, tapi = small_models(32)
    with pytest.raises(RuntimeError, match="CUDA"):
        FLSimulation(tapi.cfg, FLConfig(**small_fl_kwargs(N)),
                     scenario_config("ring", num_vehicles=N), "mnist", "contextual",
                     prng.key(0))


def test_cli_runs_on_the_cpu_and_refuses_unported_lanes(tmp_path, capsys):
    out = tmp_path / "run.json"
    fl_sim.main(["--rounds", "1", "--num-clients", "10", "--device", "cpu", "--quiet",
                 "--out", str(out)])
    result = json.loads(out.read_text())
    assert result["device"] == "cpu" and len(result["rounds"]) == 1
    assert "time-to-0.5-acc" in capsys.readouterr().out
    for flag, value in (("--aggregator", "fedprox"), ("--dtype", "float16"),
                        ("--scenario", "nowhere")):
        with pytest.raises(SystemExit):
            fl_sim.main(["--rounds", "1", "--device", "cpu", flag, value])
    # the bf16 lane runs
    fl_sim.main(["--rounds", "1", "--num-clients", "10", "--device", "cpu", "--quiet",
                 "--dtype", "bfloat16", "--out", str(out)])
    result = json.loads(out.read_text())
    assert result["dtype"] == "bfloat16" and len(result["rounds"]) == 1


def test_unported_lanes_raise():
    from repro_torch.fl.rounds import make_round_data, make_round_step

    _, tapi = small_models(32)
    # the bf16 forms of the flat, two-tier and unfused lanes build, fused and
    # unfused (tests/test_torch_precision_rounds.py holds them to JAX)
    for kw in (dict(hierarchical=True, client_block=4, compute_dtype="bfloat16"),
               dict(compute_dtype="bfloat16"), dict(param_dtype="bfloat16")):
        fl = FLConfig(**small_fl_kwargs(N, **kw))
        for fused in (True, False):
            assert callable(make_round_step(tapi.loss, fl, 2, 1.0, tapi.spec,
                                            aggregators=(fl.aggregator,), fused=fused))
    # Dirichlet client shards (prng.dirichlet) are the reference's
    from repro.fl.rounds import make_round_data as jmake_round_data

    kw = small_fl_kwargs(N, dirichlet_alpha=0.5)
    data = make_round_data(prng.key(0), "mnist", FLConfig(**kw),
                           torch.zeros(N, dtype=torch.int64), "cpu")
    want = jmake_round_data(jax.random.key(0), "mnist", JFLConfig(**kw),
                            jax.numpy.zeros(N, dtype=jax.numpy.int32))
    np.testing.assert_array_equal(data.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(data.images.numpy(), np.asarray(want.images), rtol=1e-5,
                               atol=1e-5)


def test_time_to_accuracy():
    from repro_torch.fl.rounds import RoundRecord

    recs = [RoundRecord(i, 10.0 * i, 10.0, 2, 2, 0.1, 0.1, a, 1.0)
            for i, a in enumerate((0.2, 0.55, 0.7), 1)]
    assert time_to_accuracy(recs, 0.5) == 20.0
    assert time_to_accuracy(recs, 0.9) is None
