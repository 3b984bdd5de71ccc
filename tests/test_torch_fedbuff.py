"""The fedbuff ring of the port: async rounds against the JAX package.

rush_hour, N=10, CR 0.5, ``buffer_fill=1``, a 32-unit MLP: deadline-missers
park their update rows in the ``(Kb, P)`` ring and land in a later round
with a staleness discount.  What is held:

* a round in which a ring slot drains AND a straggler parks (into the slot
  just freed) matches the JAX round from the same injected state: integers
  exact (``n_buffered``, ``n_drained``, ``buf_mask``, the reporting cohort,
  clusters), floats within ``test_torch_bridge.REGISTRY_ROUND_TOL``;
* an occupied ring survives ``convert`` both ways;
* the port's own ring over several rounds: parked slots carry this round's
  dispatch time and arrive a full deadline later, drains fire only at the
  fill threshold, the count of occupied slots adds up;
* the round-level contracts on the CPU, bit for bit on every state leaf
  and metric: the full registry at index 0 is the ``("fedavg",)`` round,
  and fedbuff with the buffer disabled (fill threshold above the cohort,
  CR 1.0) is the fedavg round.  (The latter's plain server step sums
  K + Kb rows, Kb of them at weight 0; at this cohort of one the CPU's
  einsum gives the K-row sum exactly.)
"""
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
from repro.sharding import split_params
from repro.utils import tree_bytes
from repro_torch import convert
from repro_torch.config import FLConfig
from repro_torch.core.scenarios import scenario_config, scenario_params
from repro_torch.fl import rounds
from repro_torch.fl.aggregators import AGGREGATOR_ORDER, FEDBUFF_IDX
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
)

N = 10
SCENARIO = "rush_hour"


@pytest.fixture(scope="module")
def jax_ring_run():
    """JAX rounds of the fedbuff lane until one both drains and parks:
    (state before that round, the round's state and metrics, data, port step)."""
    kw = dict(connection_rate=0.5, buffer_fill=1)
    state, data, fl, api = jax_experiment(scenario=SCENARIO, n_clients=N, **kw)
    spec_tree = jax.eval_shape(lambda k: split_params(api.init(k))[0], jax.random.key(0))
    mb = float(tree_bytes(spec_tree))
    jstep = jax.jit(jmake_round_step(api.loss, fl, fl.n_select, mb, flat_spec_of(spec_tree),
                                     ("contextual",), aggregators=JAGGREGATOR_ORDER))
    jscn = jscenario_params(jscenario_config(SCENARIO, num_vehicles=N))
    zero, ai = jnp.int32(0), jnp.int32(FEDBUFF_IDX)
    for _ in range(8):
        prev = state
        state, m = jstep(prev, jscn, zero, ai, data, True)
        if int(m.n_drained) > 0 and int(m.n_buffered) > 0:
            break
    _, tapi = small_models()
    tfl = FLConfig(**small_fl_kwargs(N, **kw))
    tstep = rounds.make_round_step(tapi.loss, tfl, tfl.n_select, mb, tapi.spec,
                                   ("contextual",), aggregators=AGGREGATOR_ORDER)
    return dict(prev=prev, state=state, metrics=m, data=data, tstep=tstep)


def test_drain_and_park_round_matches_the_jax_round(jax_ring_run):
    run = jax_ring_run
    prev, js, jm = run["prev"], run["state"], run["metrics"]
    # premise: a slot drains and a straggler parks in the same round
    assert int(jm.n_drained) > 0 and int(jm.n_buffered) > 0
    assert np.asarray(prev.buf_mask).any()
    ts = convert.state_from_numpy(state_to_numpy(prev))
    td = convert.data_from_numpy(data_to_numpy(run["data"]))
    scn = scenario_params(scenario_config(SCENARIO, num_vehicles=N))
    ts2, tm = run["tstep"](ts, scn, 0, FEDBUFF_IDX, td, True)
    assert_round_matches(tm, ts2, jm, js)
    # the drained update moved the model
    assert not torch.equal(ts2.params, ts.params)


def test_occupied_ring_survives_convert(jax_ring_run):
    ref = state_to_numpy(jax_ring_run["state"])
    assert ref["buf_mask"].any() and np.abs(ref["buf_delta"]).max() > 0
    back = convert.state_to_numpy(convert.state_from_numpy(ref))
    for f in ("buf_delta", "buf_arrive", "buf_sent", "buf_weight", "buf_mask",
              "opt_m", "opt_v"):
        assert back[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(back[f], ref[f], err_msg=f)


def _port_env(aggregators=AGGREGATOR_ORDER, **kw):
    """A port (state, data, scn, step) at N=10 on rush_hour, no JAX."""
    _, tapi = small_models()
    fl = FLConfig(**small_fl_kwargs(N, samples_per_client=32, batch_size=16, **kw))
    scn = scenario_params(scenario_config(SCENARIO, num_vehicles=N))
    state, regions = rounds.init_state(tapi, fl, scn, "mnist", "contextual", prng.key(0),
                                       "cpu")
    data = rounds.make_round_data(state.key, "mnist", fl, regions, "cpu")
    step = rounds.make_round_step(tapi.loss, fl, fl.n_select, float(tree_bytes_t(tapi.spec)),
                                  tapi.spec, ("contextual",), aggregators=aggregators)
    return state, data, scn, step


def test_ring_parks_then_drains_over_rounds():
    state, data, scn, step = _port_env(connection_rate=0.5, buffer_fill=1)
    tot_buffered = tot_drained = 0
    for _ in range(8):
        prev = state
        state, m = step(state, scn, 0, FEDBUFF_IDX, data, False)
        nb, nd = int(m.n_buffered), int(m.n_drained)
        tot_buffered, tot_drained = tot_buffered + nb, tot_drained + nd
        occ = state.buf_mask
        # slots parked this round carry its dispatch time (sim time only
        # grows, so no older slot has it) and arrive a deadline later
        fresh = occ & (state.buf_sent == prev.sim_time)
        assert int(fresh.sum()) == nb
        assert bool((state.buf_arrive[fresh] >= state.buf_sent[fresh] + 15.0).all())
        assert int(occ.sum()) == int(prev.buf_mask.sum()) - nd + nb
        if nb > 0 and int(m.n_succeeded) == 0 and nd == 0:
            assert torch.equal(state.params, prev.params)  # parking alone moves nothing
        assert torch.isfinite(state.params).all()
    assert tot_buffered > 0 and tot_drained > 0


def test_drain_fires_only_at_fill_threshold():
    state, data, scn, step = _port_env(connection_rate=0.4, buffer_fill=3)
    for _ in range(10):
        state, m = step(state, scn, 0, FEDBUFF_IDX, data, False)
        nd = int(m.n_drained)
        assert nd == 0 or nd >= 3, nd
        assert torch.isfinite(state.params).all()


def _assert_states_equal(a, b):
    for f in rounds.RoundState._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f == "twin":
            assert all(torch.equal(p, q) for p, q in zip(x, y)), f
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert x == y, f


def _assert_metrics_equal(a, b):
    for f in rounds.RoundMetrics._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)) or (
            torch.isnan(getattr(a, f)).all() and torch.isnan(getattr(b, f)).all()), f


def test_full_registry_at_index_0_is_the_fedavg_round():
    """Contract (a) at round level: every state leaf and metric, bit for bit."""
    state, data, scn, legacy = _port_env(("fedavg",), connection_rate=0.7)
    _, _, _, general = _port_env(connection_rate=0.7)
    for _ in range(3):
        s_l, m_l = legacy(state, scn, 0, 0, data, True)
        s_g, m_g = general(state, scn, 0, 0, data, True)
        _assert_states_equal(s_l, s_g)
        _assert_metrics_equal(m_l, m_g)
        state = s_l


def test_disabled_buffer_is_the_fedavg_round():
    state, data, scn, legacy = _port_env(("fedavg",), connection_rate=1.0)
    _, _, _, general = _port_env(connection_rate=1.0, buffer_fill=N)
    s_l, m_l = legacy(state, scn, 0, 0, data, True)
    s_f, m_f = general(state, scn, 0, FEDBUFF_IDX, data, True)
    # premise: nobody misses at CR 1.0, so the ring stays empty
    assert int(m_f.n_selected) > 0 and int(m_f.n_succeeded) == int(m_f.n_selected)
    assert int(m_f.n_buffered) == 0 and int(m_f.n_drained) == 0
    _assert_states_equal(s_l, s_f)
    _assert_metrics_equal(m_l, m_f)
