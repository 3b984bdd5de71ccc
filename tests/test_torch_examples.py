"""The port's drivers of the two remaining reference examples, on the CPU.

``python -m repro_torch.launch.serve_decode`` against ``examples/serve_decode.py``
(the mixtral-8x7b smoke config in fp32, a 4 x 48 prefill and 24 greedy
steps through the 32-slot window ring): the same three lines, the greedy
tokens equal.  ``python -m repro_torch.launch.fl_cits_benchmark --rounds 2
--clients 12`` against ``examples/fl_cits_benchmark.py``'s
``run_experiment`` calls: each strategy's records with their integers equal
and their floats within rtol 1e-5 / atol 1e-6 (one round of the port is the
reference's to float tolerance, ``tests/test_torch_round.py``), and the same
lines but for the last digit of a float.
"""
import contextlib
import io
import re
import runpy
import sys

import numpy as np
import pytest

from repro_torch.launch import fl_cits_benchmark, serve_decode
from test_torch_bridge import _one_thread  # noqa: F401  (autouse fixture)

INTS = ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained")


def _run_example(path, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "argv", [path] + argv)
        runpy.run_path(path, run_name="__main__")
    return out.getvalue()


def test_serve_decode_prints_the_example_lines_and_tokens():
    ref = _run_example("examples/serve_decode.py", [])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tokens = serve_decode.main(["--device", "cpu"])
    assert out.getvalue() == ref
    sample = re.search(r"sample: (\[.*\])", ref).group(1)
    assert str(tokens[0].tolist()) == sample
    assert tokens.shape == (serve_decode.BATCH, serve_decode.GEN)


def test_fl_cits_benchmark_matches_the_example(monkeypatch):
    """The example's run with ``run_experiment`` wrapped to keep its results:
    the records and the lines of the same run."""
    import repro.launch.fl_sim as jfl_sim

    want, run = {}, jfl_sim.run_experiment

    def keep(dataset, strategy, *a, **kw):
        want[strategy] = run(dataset, strategy, *a, **kw)
        return want[strategy]

    monkeypatch.setattr(jfl_sim, "run_experiment", keep)
    ref = _run_example("examples/fl_cits_benchmark.py", ["--rounds", "2", "--clients", "12"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fl_cits_benchmark.main(["--rounds", "2", "--clients", "12", "--device", "cpu"])
    assert list(got) == list(want) == ["contextual", "network", "gossip"]
    for strategy, r in got.items():
        w = want[strategy]
        assert r["time_to_acc_0.5"] == w["time_to_acc_0.5"]
        assert len(r["rounds"]) == len(w["rounds"]) == 2
        for a, b in zip(r["rounds"], w["rounds"]):
            assert sorted(a) == sorted(b)
            for k in b:
                if k in INTS:
                    assert a[k] == b[k], (strategy, k)
                else:
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6,
                                               err_msg=f"{strategy} {k}")
    # the lines, but for the last printed digit of an accuracy
    strip = lambda s: re.sub(r"acc=\d\.\d\d\d", "acc=", s)  # noqa: E731
    assert strip(out.getvalue()) == strip(ref)
    assert out.getvalue().count("time-to-0.5=") == 3
