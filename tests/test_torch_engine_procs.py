"""The engine's process lane on the CPU: each shard of a sharded grid swept
by a worker process of its own (``ExperimentEngine(..., processes=True)``,
``repro_torch.utils.procs.ShardPool``).

A lane's arithmetic does not depend on its shard or its process, so every
metric of every lane must equal the unsharded grid's and the in-process
turn's bit for bit (NaN alike), with the same ``runs`` and
``last_data_plan``.  Grids at ``tests/test_torch_engine_sharded.py``'s N
and P: a ``("fedavg",)`` grid of 4 lanes and a ``fedbuff`` grid of 3 (one
scenario a custom ``TrafficConfig``), each on 2 and 3 shards (the pad path
on one of them).  Also: a second ``run_grid`` reusing the workers,
``close()`` and the context manager ending them, a worker's exception and
a killed worker raising in the caller within a set time (and closing the
pool, never falling back to the in-process turn), the workers' launch
counts added to the caller's, arguments that do not pickle refused before
anything is sent, and the lane rule (``shards_in_processes``): a repeated
device keeps the in-process turn unless asked.  Every pool start-up costs a
torch import a worker, so the file shares its engines.
"""
import os
import signal
import threading
import time

import pytest
import torch

import _shard_workers as workers
from repro_torch.config import FLConfig, ModelConfig, TrafficConfig
from repro_torch.core.scenarios import scenario_config
from repro_torch.fl import ExperimentEngine
from repro_torch.fl import engine as engine_mod
from repro_torch.kernels import launch_counts
from repro_torch.launch.mesh import make_grid_mesh
from repro_torch.utils import procs
from repro_torch.utils.procs import ShardPool, WorkerError

# tests/test_torch_engine_sharded.py's config and model
FL = dict(num_clients=12, samples_per_client=64, local_epochs=1, num_clusters=4,
          batch_size=32, recluster_every=2)
MLP = dict(name="mlp", family="mlp", num_layers=0, d_model=0, num_heads=0, num_kv_heads=0,
           d_ff=48, vocab_size=0, image_shape=(28, 28, 1), num_classes=10, channels=())
INTS = ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained")
PLATOON = scenario_config("platoon", num_vehicles=FL["num_clients"])
# name -> (engine kwargs, run_grid kwargs): 4 lanes (3 shards pad 2), 3 lanes
# (2 shards pad 1) of which one a custom scenario
GRIDS = {
    "fedavg": (dict(aggregators=("fedavg",)),
               dict(seeds=(0, 1), scenarios=("ring", "rush_hour"), rounds=2, eval_every=2)),
    "fedbuff": (dict(aggregators=("fedbuff",), fl=dict(connection_rate=0.7)),
                dict(seeds=(0,), scenarios=("ring", PLATOON, "rush_hour"), rounds=3,
                     eval_every=2)),
}
SHARDS = (2, 3)


@pytest.fixture(autouse=True)
def _one_thread():
    """Six xdist workers share the CPU: one torch thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engine(name, **kw):
    ekw, _ = GRIDS[name]
    fl = FLConfig(**{**FL, **ekw.get("fl", {})})
    return ExperimentEngine(ModelConfig(**MLP), fl, "mnist", aggregators=ekw["aggregators"],
                            **kw)


def _assert_bitwise(got, want):
    assert got.runs == want.runs
    for f in want.metrics._fields:
        x, y = getattr(got.metrics, f), getattr(want.metrics, f)
        assert x.shape == y.shape, f
        if f in INTS:
            assert torch.equal(x, y), f
        else:
            assert torch.equal(torch.isnan(x), torch.isnan(y)), f
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), f


def _dead(pids):
    """Whether none of ``pids`` is alive (a reaped child is gone)."""
    for pid in pids:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        return False
    return True


@pytest.fixture(scope="module")
def lanes():
    """(name, shards) -> (process engine, its result, the in-process
    engine's result, the unsharded result).  The process engines stay open
    for the module (the close test ends one first) and are closed at its
    end."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    out, engines = {}, []
    try:
        for name, (_, grid) in GRIDS.items():
            want = _engine(name, device="cpu").run_grid(**grid)
            for n in SHARDS:
                mesh = make_grid_mesh(n, device="cpu")
                turn = _engine(name, mesh=mesh, processes=False)
                eng = _engine(name, mesh=mesh, processes=True)
                engines.append(eng)
                out[name, n] = eng, eng.run_grid(**grid), turn.run_grid(**grid), want
                assert turn._pool is None and turn.last_shard_stats is None
                assert turn.last_data_plan == eng.last_data_plan
        yield out
    finally:
        for eng in engines:
            eng.close()
        torch.set_num_threads(prev)


# ---- every lane bit for bit ----------------------------------------------------------------

@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("name", list(GRIDS))
def test_the_process_lane_is_the_unsharded_grid_and_the_in_process_turn_bitwise(lanes, name,
                                                                                 n):
    eng, got, turn, want = lanes[name, n]
    assert eng.processes and eng.grid_shards() == n
    _assert_bitwise(got, want)
    _assert_bitwise(turn, want)
    G = len(want.runs)
    assert eng.last_data_plan["n_shards"] == n
    stats = eng.last_shard_stats
    assert [s["device"] for s in stats] == ["cpu"] * n
    assert [s["lanes"] for s in stats] == [-(-G // n)] * n
    assert all(s["sweep_s"] > 0 and s["peak_bytes"] is None for s in stats)
    assert len({s["pid"] for s in stats} | {os.getpid()}) == n + 1
    assert eng.pool_start_s > 0


def test_the_grids_exercise_their_lanes(lanes):
    """The fedbuff grid parks and drains; one shard count pads each grid."""
    m = lanes["fedbuff", 2][1].metrics
    assert int(m.n_buffered.sum()) > 0 and int(m.n_drained.sum()) > 0
    for name, (_, grid) in GRIDS.items():
        G = len(grid["seeds"]) * len(grid["scenarios"])
        assert any(G % n for n in SHARDS), name


def test_a_second_run_grid_reuses_the_workers(lanes):
    eng = lanes["fedavg", 2][0]
    pids = list(eng._pool.pids)
    grid = dict(seeds=(2,), scenarios=("platoon", "ring", "highway"), rounds=1, eval_every=1)
    got = eng.run_grid(**grid)
    assert eng._pool.pids == pids and [s["pid"] for s in eng.last_shard_stats] == pids
    _assert_bitwise(got, _engine("fedavg", device="cpu").run_grid(**grid))


def test_the_workers_launches_are_added_to_the_callers(lanes, monkeypatch):
    """Each worker's launch-counter deltas (rank r: r + 1 B1g, 2 (r + 1)
    B2g) are added to the calling process's counters, exactly."""
    eng = lanes["fedavg", 3][0]
    monkeypatch.setattr(engine_mod, "_shard_sweep", workers.counted_sweep)
    before = launch_counts()
    got = eng.run_grid(**GRIDS["fedavg"][1])
    after = launch_counts()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert delta == {("rttg_latency", "grid_launches"): 6,
                     ("fedavg_reduce", "grid_launches"): 12}
    _assert_bitwise(got, lanes["fedavg", 3][3])


def test_runs_that_do_not_pickle_are_refused_before_anything_is_sent(lanes):
    class Local(TrafficConfig):
        pass

    eng = lanes["fedavg", 2][0]
    pids = list(eng._pool.pids)
    with pytest.raises(TypeError, match="custom TrafficConfig"):
        eng.run_grid(seeds=(0,), scenarios=(Local(num_vehicles=FL["num_clients"]),),
                     rounds=1)
    assert eng._pool is not None and eng._pool.alive and eng._pool.pids == pids


# ---- the pool's life -------------------------------------------------------------------------

def test_close_and_the_context_manager_end_the_workers(lanes):
    eng = lanes["fedbuff", 3][0]
    pids = list(eng._pool.pids)
    eng.close()
    assert eng._pool is None and _dead(pids)
    eng.close()  # idempotent
    grid = dict(seeds=(1,), scenarios=("ring",), rounds=1, eval_every=1)
    with eng:
        got = eng.run_grid(**grid)  # a new pool, started at first use
        again = list(eng._pool.pids)
    assert not set(again) & set(pids) and eng._pool is None and _dead(again)
    _assert_bitwise(got, _engine("fedbuff", device="cpu").run_grid(**grid))


def test_a_repeated_device_takes_the_in_process_turn_unless_asked(monkeypatch):
    """``processes=None``: a mesh that repeats a device (every CPU mesh)
    sweeps on the calling thread and starts no pool; a mesh of distinct
    devices takes the process lane; a mesh of one never does."""
    def refuse(*args, **kwargs):
        raise AssertionError("a pool was started")

    monkeypatch.setattr(engine_mod, "ShardPool", refuse)
    eng = _engine("fedavg", mesh=make_grid_mesh(2, device="cpu"))
    assert not eng.processes
    res = eng.run_grid(seeds=(0, 1), scenarios=("ring",), rounds=1, eval_every=1)
    assert res.metrics.round.shape == (2, 1) and eng._pool is None
    assert eng.last_shard_stats is None and eng.pool_start_s is None
    assert not _engine("fedavg", mesh=make_grid_mesh(1, device="cpu"), processes=True).processes
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    rule = engine_mod.shards_in_processes
    assert rule((c0, c1)) and rule((c0, c1, torch.device("cuda", 2)))
    assert not rule((c0, c0)) and not rule((cpu, cpu)) and not rule((c0, c1, c0))
    assert rule((c0, c0), True) and rule((cpu, cpu), True) and not rule((c0, c1), False)
    assert not rule((c0,)) and not rule((c0,), True)


def test_a_workers_exception_raises_in_the_caller_with_its_traceback():
    """An engine whose workers fail (an unknown dataset, met only when a
    worker builds its lanes): ``run_grid`` raises the worker's traceback,
    the pool is closed and nothing ran in-process."""
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "no-such-dataset",
                           mesh=make_grid_mesh(2, device="cpu"), processes=True)
    with pytest.raises(WorkerError, match="(?s)raised in _shard_sweep.*Traceback") as info:
        eng.run_grid(seeds=(0,), scenarios=("ring",), rounds=1)
    assert "no-such-dataset" in str(info.value)
    assert eng._pool is None and eng.last_shard_stats is None


def test_the_pool_runs_a_function_on_every_rank():
    """``fn(worker, *args)`` on each rank, in rank order, with the caller's
    thread count (also when it changes between calls) and what ``init``
    left; a worker that raises closes the pool with its traceback."""
    devices = make_grid_mesh(2, device="cpu")
    with ShardPool(devices, init=workers.remember, init_args=("x",)) as pool:
        outs = pool.run(workers.whoami, [()] * 2)
        assert [o[:3] for o in outs] == [(r, "cpu", 2) for r in range(2)]
        assert [o[3] for o in outs] == pool.pids and os.getpid() not in pool.pids
        assert [o[4] for o in outs] == [1] * 2
        assert [o[5] for o in outs] == [(r, "x") for r in range(2)]
        torch.set_num_threads(2)
        assert [o[4] for o in pool.run(workers.whoami, [()] * 2)] == [2] * 2
        torch.set_num_threads(1)
        with pytest.raises(ValueError, match="3 argument tuples for 2 workers"):
            pool.run(workers.whoami, [()] * 3)
        with pytest.raises(WorkerError, match="(?s)worker 1 .*raised.*ValueError: boom on "
                                              "rank 1"):
            pool.run(workers.boom, [(1,)] * 2)
        assert not pool.alive and _dead(pool.pids)
        with pytest.raises(WorkerError, match="closed"):
            pool.run(workers.whoami, [()] * 2)


def test_a_worker_killed_mid_call_raises_within_a_set_time():
    """SIGKILL to one worker during a 60 s call: ``run`` raises within
    ``POLL_S`` and the others' grace, and every worker is gone."""
    with ShardPool(make_grid_mesh(2, device="cpu")) as pool:
        victim = pool.pids[1]
        timer = threading.Timer(1.0, os.kill, (victim, signal.SIGKILL))
        t0 = time.monotonic()
        timer.start()
        with pytest.raises(WorkerError, match=f"worker 1 on cpu \\(pid {victim}\\) died in nap "
                                              "with exit code -9"):
            pool.run(workers.nap, [(60.0,)] * 2)
        assert time.monotonic() - t0 < 1.0 + procs.POLL_S + 5.0
        assert not pool.alive and _dead(pool.pids)


def test_a_worker_that_fails_to_start_raises():
    with pytest.raises(WorkerError, match="(?s)worker 0 .*raised in start-up.*boom on rank 0"):
        ShardPool(make_grid_mesh(2, device="cpu"), init=workers.boom, init_args=(0,))
