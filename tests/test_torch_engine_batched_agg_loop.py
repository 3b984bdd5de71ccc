"""The batched grid round under every server rule against the lane loop, bit
for bit on the CPU.

The same lanes through both of the engine's paths, as
``tests/test_torch_engine_batched_loop.py`` holds the ``("fedavg",)``
round: ``_lanes`` (stacked, one round of every lane at once, each lane's
rule a ``(G,)`` device index) and ``_lane_list`` (one state a lane, run one
after another through the one-lane round step).  On the CPU at one thread
every metric and every state leaf of every lane (the server moments and
the fedbuff ring among them) must be equal bit for bit, NaN alike.
Registries: the full catalog; the four rules of ``server_update`` alone;
``("fedbuff",)`` (N = 12, CR 0.7: its ring must park and drain); bf16
update rows and ring under ``("fedadam", "fedbuff")``; a bf16 master under
``("fedadam",)``.  Strategies ``("greedy", "contextual")`` (K = N = 12) x
scenarios ``("ring", "platoon", "rsu_outage")``, 3 rounds, eval every 2.
"""
import pytest
import torch

from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine
from repro_torch.fl.aggregators import AGGREGATOR_ORDER
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import FL, MLP
from test_torch_engine_batched_loop import _same, state_lane

CASES = {
    "full registry": (AGGREGATOR_ORDER, dict(FL)),
    "server_update rules": (("fedavgm", "fedadam", "fedyogi", "stale"), dict(FL)),
    "fedbuff": (("fedbuff",), dict(FL)),
    "bf16 rows, fedadam + fedbuff": (("fedadam", "fedbuff"), dict(FL, compute_dtype="bfloat16")),
    "bf16 master, fedadam": (("fedadam",), dict(FL, param_dtype="bfloat16",
                                                compute_dtype="bfloat16")),
}
STRATEGIES = ("greedy", "contextual")
SCENARIOS = ("ring", "platoon", "rsu_outage")


@pytest.mark.parametrize("name", list(CASES))
def test_batched_sweep_under_the_registry_is_the_lane_loop_bitwise(name):
    registry, fl = CASES[name]
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**fl), "mnist", device="cpu",
                           strategies=STRATEGIES, aggregators=registry)
    assert eng.batched
    seeds = (0, 1) if registry == ("fedbuff",) else (0,)
    runs = [(st, a, s, sc) for st in STRATEGIES for a in registry for s in seeds
            for sc in SCENARIOS]
    batched, loop = eng._lanes(runs), eng._lane_list(runs)
    got, want = eng._sweep(batched, 3, 2), eng._sweep(loop, 3, 2)
    for f in got._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    for g, run in enumerate(runs):
        lane = state_lane(batched.state, g)
        for f in lane._fields:
            x, y = getattr(lane, f), getattr(loop.states[g], f)
            same = all(_same(p, q) for p, q in zip(x, y)) if f == "twin" else _same(x, y)
            assert same, (run, f)
    for f in ("params", "opt_m", "opt_v", "buf_delta", "buf_weight", "sketches"):
        # the grid kernels take contiguous lanes, round after round
        assert getattr(batched.state, f).is_contiguous(), f
    if "fedbuff" in registry:  # the ring parked stragglers and drained them
        fedbuff = torch.tensor([r[1] == "fedbuff" for r in runs])
        assert int(got.n_buffered[fedbuff].sum()) > 0 and int(got.n_drained[fedbuff].sum()) > 0
        assert bool(batched.state.buf_mask.any())
    if any(a in ("fedavgm", "fedadam", "fedyogi") for a in registry):
        assert bool((batched.state.opt_m != 0).any())  # the moments moved
