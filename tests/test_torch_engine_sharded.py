"""The engine's grid sharded over a mesh, against the unsharded grid, on the CPU.

``ExperimentEngine(..., mesh=make_grid_mesh(n, device="cpu"))`` cuts a grid
into n contiguous shards (padded by repeating the last run), builds each
shard's lanes and de-duplicated data rows on its device, sweeps its lane
groups there and gathers the metrics in run order.  A lane's arithmetic does
not depend on its shard, so every metric of every lane must equal the
unsharded grid's bit for bit (NaN alike) and ``runs`` must be the same.
Grids: ``tests/test_engine.py``'s sharded ones (N = 12, 64 samples, ``d_ff``
48: the catalog's 8 lanes, the 6-lane pad path, the seed-heavy grid, and the
aggregator axis), a ``fedbuff`` registry at CR 0.7, a streamed two-tier grid
and the lane loop, on 4 or 2 shards.  ``last_data_plan`` must equal the plan
``repro.fl.partition.shard_local_rows`` gives for the same grid and shard
count, and the port's ``shard_local_rows`` the reference's.  The grid's
lanes against the reference engine are held by ``test_torch_engine.py``;
here one seed-heavy sharded grid is held against the reference's
``run_grid`` too.  Also here: the mesh's refusals without CUDA, the shards
run on the calling thread, and the kernel helpers that let any host thread
launch on any card (the locked launch counters, the build locked across
threads and across processes, every C entry call made on its operand's
card, the per-device shared-memory grants), and the eval's test loss
through ``row_mean``, whose value for a lane does not depend on its lane
group.
"""
import ast
import shutil
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis wheel: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

import jax
from repro.config import FLConfig as JFLConfig
from repro.config import ModelConfig as JModelConfig
from repro.core.scenarios import data_signature as jdata_signature
from repro.core.scenarios import scenario_config as jscenario_config
from repro.fl import partition as jpartition
from repro.fl.engine import ExperimentEngine as JEngine
from repro_torch.config import FLConfig, ModelConfig
from repro_torch.fl import ExperimentEngine, partition
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import count_launch, indexed
from repro_torch.launch.mesh import GridMesh, make_grid_mesh
from repro_torch.models import mlp
from repro_torch.utils.elementwise import row_mean
from test_torch_bridge import _one_thread  # noqa: F401
from test_torch_engine import ATOL, INTS, MLP, RTOL

# tests/test_engine.py's sharded-grid config (its FL: CR 1.0)
FL = dict(num_clients=12, samples_per_client=64, local_epochs=1, num_clusters=4,
          batch_size=32, recluster_every=2)
CATALOG = ("day_cycle", "hetero_fleet", "highway", "platoon", "ring", "rsu_outage",
           "rush_hour", "urban_grid")
# (engine kwargs, run_grid kwargs, shards): tests/test_engine.py's four sharded
# grids (at 2 rounds: a re-clustering and an eval), then the async registry, the
# streamed two-tier lanes and the lane loop
GRIDS = {
    "catalog": ({}, dict(seeds=(0,), scenarios=CATALOG, rounds=2, eval_every=2), 4),
    "pad": ({}, dict(seeds=(0, 1), scenarios=("ring", "rush_hour", "platoon"), rounds=2,
                     eval_every=2), 4),
    "seeds": ({}, dict(seeds=(0, 1, 2, 3), scenarios=("ring",), rounds=2, eval_every=2), 4),
    "aggregators": (dict(aggregators=("fedavg", "fedadam")),
                    dict(seeds=(0, 1), scenarios=("ring", "rush_hour"), rounds=2,
                         eval_every=2), 4),
    "fedbuff": (dict(aggregators=("fedbuff",), fl=dict(connection_rate=0.7)),
                dict(seeds=(0,), scenarios=("ring", "platoon", "rush_hour"), rounds=3,
                     eval_every=2), 2),
    "streamed": (dict(fl=dict(num_clients=20, hierarchical=True, client_block=1)),
                 dict(seeds=(0,), scenarios=("ring", "rsu_outage", "platoon"), rounds=2,
                      eval_every=2), 2),
    "lane loop": (dict(loop=True), dict(seeds=(0,), scenarios=("ring", "platoon", "rush_hour"),
                                        rounds=2, eval_every=2), 2),
}


def _engines(name, mesh):
    """(unsharded, sharded) port engines of grid ``name`` on the CPU."""
    kw, _, _ = GRIDS[name]
    fl = FLConfig(**{**FL, **kw.get("fl", {})})
    agg = kw.get("aggregators", ("fedavg",))
    pair = (ExperimentEngine(ModelConfig(**MLP), fl, "mnist", aggregators=agg, device="cpu"),
            ExperimentEngine(ModelConfig(**MLP), fl, "mnist", aggregators=agg, mesh=mesh))
    for eng in pair:
        eng.batched = not kw.get("loop", False)
    return pair


@pytest.fixture(scope="module")
def sharded():
    """name -> (sharded engine, sharded result, unsharded result) of every grid."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name, (_, grid, n) in GRIDS.items():
            base, eng = _engines(name, make_grid_mesh(n, device="cpu"))
            out[name] = eng, eng.run_grid(**grid), base.run_grid(**grid)
            assert base.last_data_plan is None
        return out
    finally:
        torch.set_num_threads(prev)


def _reference_plan(name):
    """The reference engine's ``last_data_plan`` for grid ``name``: its row
    index (one row per unique (strategy, seed, data_signature)) padded by
    repeating the last lane, through ``repro.fl.partition.shard_local_rows``."""
    kw, grid, n = GRIDS[name]
    aggs = kw.get("aggregators", ("fedavg",))
    vehicles = kw.get("fl", {}).get("num_clients", FL["num_clients"])
    rows, didx = {}, []
    for agg in aggs:  # (strategy x aggregator x seed x scenario), one strategy
        for seed in grid["seeds"]:
            for sc in grid["scenarios"]:
                sig = jdata_signature(jscenario_config(sc, num_vehicles=vehicles))
                didx.append(rows.setdefault(("contextual", seed, sig), len(rows)))
    didx += didx[-1:] * (-len(didx) % n)
    shard_rows, _ = jpartition.shard_local_rows(np.asarray(didx, np.int32), n)
    return {"total_rows": len(rows), "rows_per_shard": shard_rows.shape[1], "n_shards": n}


# ---- shard_local_rows ------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(n_shards=st.integers(1, 8), per=st.integers(1, 6),
       rows=st.lists(st.integers(0, 9), min_size=48, max_size=48))
def test_shard_local_rows_matches_the_reference(n_shards, per, rows):
    didx = np.asarray(rows[:n_shards * per], np.int32)
    got_rows, got_idx = partition.shard_local_rows(didx, n_shards)
    want_rows, want_idx = jpartition.shard_local_rows(didx, n_shards)
    assert got_rows.dtype == np.int32 and got_idx.dtype == np.int32
    np.testing.assert_array_equal(got_rows, want_rows)
    np.testing.assert_array_equal(got_idx, want_idx)
    # every lane reads its own global row through its shard's slice
    shard = np.repeat(np.arange(n_shards), per)
    np.testing.assert_array_equal(got_rows[shard, got_idx], didx)


def test_shard_local_rows_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="do not split"):
        partition.shard_local_rows([0, 1, 2], 2)


# ---- the sharded grids -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(GRIDS))
def test_sharded_grid_is_the_unsharded_grid_bitwise(sharded, name):
    eng, got, want = sharded[name]
    assert eng.grid_shards() == GRIDS[name][2] and eng.device == torch.device("cpu")
    assert got.runs == want.runs
    for f in got.metrics._fields:
        x, y = getattr(got.metrics, f), getattr(want.metrics, f)
        assert x.shape == y.shape == (len(want.runs), GRIDS[name][1]["rounds"]), f
        if f in INTS:
            assert torch.equal(x, y), f
        else:
            assert torch.equal(torch.isnan(x), torch.isnan(y)), f
            assert torch.equal(x.nan_to_num(), y.nan_to_num()), f


@pytest.mark.parametrize("name", list(GRIDS))
def test_last_data_plan_is_the_references(sharded, name):
    eng, _, _ = sharded[name]
    assert eng.last_data_plan == _reference_plan(name)


def test_seed_heavy_shards_each_build_one_row(sharded):
    """tests/test_engine.py's assertion: 4 seeds x ring on 4 shards, one
    data row a shard out of 4."""
    assert sharded["seeds"][0].last_data_plan == {"total_rows": 4, "rows_per_shard": 1,
                                                  "n_shards": 4}


def test_the_grids_exercise_their_lanes(sharded):
    """The fedbuff grid parks and drains, the streamed grid takes more than
    one chunk, and the lane-loop engine took the lane loop."""
    m = sharded["fedbuff"][1].metrics
    assert int(m.n_buffered.sum()) > 0 and int(m.n_drained.sum()) > 0
    eng = sharded["streamed"][0]
    assert eng.batched and eng.cohort_size > eng.fl.client_block
    assert not sharded["lane loop"][0].batched


def test_sharded_seed_grid_matches_the_reference_run_grid(sharded):
    """The seed-heavy sharded grid against the reference engine's run_grid
    (its unsharded vmapped program): integers equal, floats within the
    reference's own tolerance, NaN alike."""
    _, grid, _ = GRIDS["seeds"]
    ref = JEngine(JModelConfig(**MLP), JFLConfig(**FL), "mnist").run_grid(**grid)
    got = sharded["seeds"][1]
    assert got.runs == ref.runs
    for f in got.metrics._fields:
        a, b = getattr(got.metrics, f).numpy(), np.asarray(getattr(ref.metrics, f))
        if f in INTS:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=f)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
    jax.clear_caches()


def test_a_mesh_of_one_is_unsharded():
    base, eng = _engines("seeds", make_grid_mesh(1, device="cpu"))
    grid = dict(GRIDS["seeds"][1], seeds=(0, 1), rounds=1, eval_every=1)
    got, want = eng.run_grid(**grid), base.run_grid(**grid)
    assert eng.grid_shards() == 1 and eng.last_data_plan is None
    assert all(torch.equal(x.nan_to_num(), y.nan_to_num())
               for x, y in zip(got.metrics, want.metrics))


def test_the_shards_run_on_the_calling_thread(monkeypatch):
    """No thread starts: the calling thread sweeps the shards in mesh order."""
    def refuse(self):
        raise AssertionError("the sharded grid started a thread")

    monkeypatch.setattr(threading.Thread, "start", refuse)
    _, eng = _engines("seeds", make_grid_mesh(2, device="cpu"))
    res = eng.run_grid(seeds=(0, 1), scenarios=("ring",), rounds=1, eval_every=1)
    assert eng.last_data_plan == {"total_rows": 2, "rows_per_shard": 1, "n_shards": 2}
    assert res.metrics.round.shape == (2, 1)


# ---- the eval's test loss, whatever the lane group ----------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 64, 2000])
def test_row_mean_of_a_row_does_not_depend_on_the_rows_beside_it(n):
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((24, n)).astype(np.float32))
    got = row_mean(x)
    for k in (1, 5, 12):
        assert torch.equal(row_mean(x[:k]), got[:k])
    np.testing.assert_allclose(got.numpy(), x.double().mean(-1).numpy(), rtol=1e-6, atol=1e-6)


def test_the_eval_loss_takes_row_mean_and_a_local_step_does_not(monkeypatch):
    """``loss_from_logits``: under grad mode (a local step, which reads only
    the loss) ``ce`` is the loss itself and ``row_mean`` is not called; with
    grad mode off (the rounds' eval) ``ce`` is ``row_mean`` of the
    per-sample losses."""
    calls = []
    monkeypatch.setattr(mlp, "row_mean", lambda x: calls.append(tuple(x.shape)) or row_mean(x))
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 50, 10)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (3, 50)))
    with torch.enable_grad():
        loss, m = mlp.loss_from_logits(logits.clone().requires_grad_(True), labels)
    assert m["ce"] is loss and not calls
    with torch.no_grad():
        loss, m = mlp.loss_from_logits(logits, labels)
    assert calls == [(3, 50)]
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, labels[..., None])[..., 0]
    assert torch.equal(m["ce"], row_mean(nll))
    np.testing.assert_allclose(m["ce"].numpy(), loss.numpy(), rtol=1e-6)


# ---- the mesh ----------------------------------------------------------------------------

def test_the_mesh_raises_without_cuda():
    """No fallback hides a device: every CUDA mesh raises on a host without
    a card, and the CPU needs its shard count."""
    assert not torch.cuda.is_available()
    for make in (make_grid_mesh, lambda: make_grid_mesh(2), lambda: GridMesh(("cuda:0",)),
                 lambda: ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist",
                                          mesh=("cuda:0", "cuda:0"))):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make()
    with pytest.raises(ValueError, match="num_devices"):
        make_grid_mesh(device="cpu")
    with pytest.raises(ValueError, match="at least one device"):
        GridMesh(())


def test_the_mesh_is_a_frozen_tuple_of_devices():
    mesh = make_grid_mesh(3, device="cpu")
    assert isinstance(mesh, tuple) and mesh.shape == {"data": 3}
    assert mesh == (torch.device("cpu"),) * 3
    assert GridMesh(["cpu", torch.device("cpu")]) == make_grid_mesh(2, device="cpu")
    with pytest.raises(AttributeError):
        mesh.devices = ()
    eng = ExperimentEngine(ModelConfig(**MLP), FLConfig(**FL), "mnist", mesh=mesh)
    assert eng.mesh == mesh and eng.device == torch.device("cpu") and eng.grid_shards() == 3


# ---- the kernel helpers: any host thread, any card ---------------------------------------

def test_launch_counts_hold_across_threads(monkeypatch):
    """``count_launch`` from 8 threads switching every microsecond loses no
    count."""
    mod = types.ModuleType("counted")
    mod.launches, mod.grid_launches = 0, 0
    monkeypatch.setitem(sys.modules, "counted", mod)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(5_000):
                count_launch("counted")
                count_launch("counted", "grid_launches")

        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(prev)
    assert (mod.launches, mod.grid_launches) == (40_000, 40_000)


def test_the_build_runs_once_for_threads_that_meet_it_at_once(monkeypatch, tmp_path):
    """``library()`` from 6 threads at once: one build, one load."""
    calls = {"build": 0, "load": 0}
    gate = threading.Barrier(6)

    def fake_build(force):
        calls["build"] += 1
        threading.Event().wait(0.05)  # a slow build: the others arrive meanwhile
        kbuild._INFO = kbuild.BuildInfo(tmp_path / "lib.so", 0.0, "")
        return kbuild._INFO

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1

        def __getattr__(self, name):
            return types.SimpleNamespace()

    monkeypatch.setattr(kbuild, "_LIBRARY", None)
    monkeypatch.setattr(kbuild, "_INFO", None)
    monkeypatch.setattr(kbuild, "_build", fake_build)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", FakeLib)
    libs = []

    def use():
        gate.wait()
        libs.append(kbuild.library())

    threads = [threading.Thread(target=use) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == {"build": 1, "load": 1} and len({id(x) for x in libs}) == 1


def test_the_build_runs_once_for_processes_that_meet_it_at_once(tmp_path):
    """``build()`` in two worker processes at once, into an empty build
    directory with the compile stubbed (1 s): one compiles, the other waits
    on the file lock and finds the library built."""
    import _shard_workers

    from repro_torch.utils.procs import ShardPool

    log = tmp_path / "compiles"
    with ShardPool(make_grid_mesh(2, device="cpu")) as pool:
        outs = pool.run(_shard_workers.stub_build, [(str(tmp_path / "kernels"), str(log))] * 2)
    assert log.read_text().split() in ([str(outs[0][0])], [str(outs[1][0])])
    assert sorted(o[1] == 0.0 for o in outs) == [False, True]
    assert outs[0][2] == outs[1][2] and Path(outs[0][2]).read_bytes() == b"stub"


def test_devices_are_indexed_for_the_caches():
    assert indexed("cpu") == torch.device("cpu")
    assert indexed(torch.device("cuda", 1)) == torch.device("cuda", 1)


KERNELS = Path(kbuild.__file__).resolve().parent


def _launch_calls(path: Path):
    """Every C entry call (``<lib>.<name>_launch(...)``) of a wrapper module,
    with whether it sits inside ``with on_card(...)``."""
    tree = ast.parse(path.read_text())
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.With) and any(
                isinstance(i.context_expr, ast.Call) and getattr(i.context_expr.func, "id", "")
                == "on_card" for i in node.items):
            inside.update(id(n) for n in ast.walk(node))
    return [(node.lineno, id(node) in inside) for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr.endswith("_launch")]


@pytest.mark.parametrize("module", ["rttg_latency", "fedavg_reduce", "server_update",
                                    "rsu_reduce", "swa_decode", "ssd_scan",
                                    "pairwise_cosine"])
def test_every_c_entry_call_is_made_on_its_operands_card(module):
    calls = _launch_calls(KERNELS / f"{module}.py")
    assert calls, module
    assert all(ok for _, ok in calls), [line for line, ok in calls if not ok]


def test_the_shared_memory_grants_are_kept_per_device():
    """No source keeps one process-wide grant; the two that keep grants use
    grants.cuh's per-device ``Grants``, which the build hashes."""
    for src in sorted((KERNELS / "csrc").glob("*.cu")):
        text = src.read_text()
        assert "static int granted" not in text, src.name
        if src.name in ("rttg_latency.cu", "ssd_scan.cu"):
            assert '#include "grants.cuh"' in text and "static Grants" in text, src.name
    assert "grants.cuh" in kbuild.HEADERS


GRANTS_STUB = """
#pragma once
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
extern int current, sets;
inline cudaError_t cudaGetDevice(int* d) { *d = current; return cudaSuccess; }
inline cudaError_t cudaGetDeviceCount(int* n) { *n = 2; return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) {
  ++sets; return cudaSuccess; }
"""
GRANTS_MAIN = """
#include <cstdio>
#include "grants.cuh"
int current = 0, sets = 0;
int main() {
  static Grants g; int kernel = 0;
  grant_on_device(&kernel, g, 1000);             // under 48 KB: nothing to grant
  grant_on_device(&kernel, g, 163840);           // card 0: granted
  grant_on_device(&kernel, g, 100000);           // smaller: kept
  current = 1;
  grant_on_device(&kernel, g, 163840);           // card 1: granted there too
  current = 0;
  grant_on_device(&kernel, g, 163840);           // card 0 again: kept
  current = 2;
  int bad = grant_on_device(&kernel, g, 163840); // not a device
  std::printf("%d %d %d %d\\n", sets, g.bytes[0], g.bytes[1], bad);
}
"""


def test_grants_cuh_grants_each_device_once(tmp_path):
    """grants.cuh compiled by the host compiler against a stand-in CUDA
    runtime of two devices: each device opted in once, a grant never
    shrinks, an unknown device refused."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build grants.cuh against a stand-in runtime")
    (tmp_path / "cuda_runtime.h").write_text(GRANTS_STUB)
    (tmp_path / "main.cpp").write_text(GRANTS_MAIN)
    exe = tmp_path / "grants"
    subprocess.run([cxx, "-std=c++17", "-I", str(tmp_path), "-I", str(KERNELS / "csrc"),
                    str(tmp_path / "main.cpp"), "-o", str(exe)], check=True)
    out = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout
    assert out.split() == ["2", "163840", "163840", "101"]
