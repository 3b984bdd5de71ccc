"""The batched grid round on the two-tier lanes against the lane loop, bit for
bit on the CPU.

The same lanes through both of the engine's paths, as
``tests/test_torch_engine_batched_agg_loop.py`` holds the flat lanes:
``_lanes`` (stacked, one round of every lane at once: the realized pass
with each client's RSU, the RSU-routed weights per lane and, streamed, one
``rsu_reduce_grid`` call a chunk into ``(G, R, P)`` partials) and
``_lane_list`` (one state a lane through the one-lane round step).  On the
CPU at one thread every metric and every state leaf of every lane (the
server moments and the fedbuff ring among them) must be equal bit for bit,
NaN alike.  N = 12, K = 5 (``select_fraction`` 0.42), CR 0.7, strategies
``("contextual", "gossip")`` x scenarios ``("ring", "rsu_outage",
"platoon")`` (``rsu_outage`` darkens 4 of the 10 RSUs), 3 rounds, eval every
2.  Cases: hierarchical unstreamed and streamed at ``client_block=2`` (3
chunks, the last padded by one slot), each under the full registry;
``("fedbuff",)`` streamed over two seeds (its ring must park and drain);
bf16 rows with bf16 chunk partials under ``("fedadam", "fedbuff")``;
``("fedavg",)`` streamed (the partials reduced by ``fedavg_reduce_grid``).
Contract (a): an unstreamed hierarchical ``("fedavg",)`` grid whose RSUs
are all live is the flat batched grid bit for bit.
"""
import pytest
import torch

from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP
from test_torch_engine_batched_loop import _same, state_lane

HIER = dict(FL, select_fraction=0.42, hierarchical=True)
CASES = {
    "unstreamed, full registry": (AGGREGATOR_ORDER, dict(HIER)),
    "streamed in 3 chunks, full registry": (AGGREGATOR_ORDER, dict(HIER, client_block=2)),
    "streamed fedbuff": (("fedbuff",), dict(HIER, client_block=2)),
    "streamed bf16 rows and partials, fedadam + fedbuff": (
        ("fedadam", "fedbuff"), dict(HIER, client_block=2, compute_dtype="bfloat16")),
    "streamed fedavg": (("fedavg",), dict(HIER, client_block=2)),
}
STRATEGIES = ("contextual", "gossip")
SCENARIOS = ("ring", "rsu_outage", "platoon")


def _engine(fl, registry):
    return ExperimentEngine(ModelConfig(**MLP), FLConfig(**fl), "mnist", device="cpu",
                            strategies=STRATEGIES, aggregators=registry)


def _assert_lanes_equal(batched, states, runs):
    for g, run in enumerate(runs):
        lane = state_lane(batched.state, g)
        for f in lane._fields:
            x, y = getattr(lane, f), getattr(states[g], f)
            same = all(_same(p, q) for p, q in zip(x, y)) if f == "twin" else _same(x, y)
            assert same, (run, f)


@pytest.mark.parametrize("name", list(CASES))
def test_batched_two_tier_sweep_is_the_lane_loop_bitwise(name):
    registry, fl = CASES[name]
    eng = _engine(fl, registry)
    assert eng.batched and eng.cohort_size == 5
    seeds = (0, 1) if registry == ("fedbuff",) else (0,)
    runs = [(st, a, s, sc) for st in STRATEGIES for a in registry for s in seeds
            for sc in SCENARIOS]
    batched, loop = eng._lanes(runs), eng._lane_list(runs)
    got, want = eng._sweep(batched, 3, 2), eng._sweep(loop, 3, 2)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    _assert_lanes_equal(batched, loop.states, runs)
    for f in ("params", "opt_m", "opt_v", "buf_delta", "sketches"):
        assert getattr(batched.state, f).is_contiguous(), f
    assert int(got.n_succeeded.sum()) > 0
    if "fedbuff" in registry:  # the ring parked stragglers and drained them
        fedbuff = torch.tensor([r[1] == "fedbuff" for r in runs])
        assert int(got.n_buffered[fedbuff].sum()) > 0 and int(got.n_drained[fedbuff].sum()) > 0
    if fl.get("compute_dtype") == "bfloat16":
        assert batched.state.buf_delta.dtype == torch.bfloat16


def test_unstreamed_two_tier_fedavg_grid_is_the_flat_grid_when_every_rsu_is_live():
    """Contract (a) over G lanes: with every RSU live the RSU-routed weights
    are the flat weights (integer sample counts), so the whole sweep is."""
    runs = [(st, "fedavg", 0, sc) for st in STRATEGIES for sc in ("ring", "platoon")]
    flat, hier = (_engine(dict(HIER, hierarchical=h), ("fedavg",)) for h in (False, True))
    lanes_f, lanes_h = flat._lanes(runs), hier._lanes(runs)
    got, want = hier._sweep(lanes_h, 3, 2), flat._sweep(lanes_f, 3, 2)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    _assert_lanes_equal(lanes_h, [state_lane(lanes_f.state, g) for g in range(len(runs))],
                        runs)
