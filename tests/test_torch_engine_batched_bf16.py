"""The batched grid round with bf16 update rows against the JAX package's engine.

``tests/test_torch_engine_batched.py``'s five-strategy ``("fedavg",)`` grid
(N = 12, CR 0.7, ``recluster_every`` 2, 3 rounds, ``eval_every`` 2) with
``compute_dtype="bfloat16"``: the clients train in bf16 over the fp32
master and the batched server reduce reads bf16 rows.  Tolerance as the
bf16 lane's tests state it (``tests/test_torch_precision_rounds.py``):
integers equal; the economics (``sim_time``, ``duration``, the mean
latencies), which price the halved upload by the fp32 lane's expressions,
within the engine tests' rtol 2e-4, atol 1e-5; test accuracy within one of
the 2,000 test images, test loss within rtol 1e-4; NaN where the reference
has NaN.
"""
import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import ATOL, FL, INTS, MLP, RTOL
from test_torch_engine_batched import GRID, LANES, STRATEGIES

FL16 = dict(FL, compute_dtype="bfloat16")
TOL = {"test_acc": (0.0, 1.0 / 2_000), "test_loss": (1e-4, 0.0)}  # else (RTOL, ATOL)


@pytest.fixture(scope="module")
def grids():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL16), "mnist", strategies=STRATEGIES,
                      aggregators=("fedavg",)).run_grid(**GRID)
        ref = jax.tree_util.tree_map(np.asarray, ref.metrics), ref.runs
        eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL16), "mnist", device="cpu",
                               strategies=STRATEGIES)
        return eng, eng.run_grid(**GRID), ref
    finally:
        torch.set_num_threads(prev)


def test_the_bf16_grid_takes_the_batched_round_with_bf16_rows(grids):
    eng, res, (_, ref_runs) = grids
    assert eng.batched and res.runs == [tuple(r) for r in ref_runs]
    lanes = eng._lanes([("gossip", "fedavg", 0, "ring")])
    assert lanes.state.buf_delta.dtype == torch.bfloat16
    assert lanes.state.params.dtype == torch.float32


@pytest.mark.parametrize("g", range(LANES))
def test_bf16_batched_lane_matches_the_reference(grids, g):
    _, res, (ref, ref_runs) = grids
    for f in res.metrics._fields:
        a = getattr(res.metrics, f)[g].numpy()
        b = np.asarray(getattr(ref, f)[g])
        what = f"{ref_runs[g]}: {f}"
        if f in INTS:
            np.testing.assert_array_equal(a, b, err_msg=what)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
        rtol, atol = TOL.get(f, (RTOL, ATOL))
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)
