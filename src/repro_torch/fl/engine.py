"""The experiment engine (``repro.fl.engine``): grids of experiments on one card or many.

A grid is the product (strategy x aggregator x seed x scenario), in that
order, as the reference forms it.  The reference runs it as one ``vmap`` of
a ``lax.scan`` over rounds.  The port takes one of two paths, chosen once,
in ``__init__``, from the engine's lane:

  * the BATCHED round (``fl.rounds.make_grid_round_step``) when N <=
    ``messages.DENSE_MAX_N`` = 4,096 (``rounds.grid_round_fits``), flat or
    two-tier, streamed or not, whatever the registry: the lanes' states stay
    stacked along a leading grid axis, as the reference keeps them, and one
    round of every lane of a lane group runs at once (two
    ``rttg_latency_grid`` launches, one
    ``rsu_reduce_grid`` launch a chunk on the streamed lanes and one
    server launch a round of each group, whatever its lanes: ``fedavg_reduce_grid`` for
    ``("fedavg",)``, ``server_update_buffered_grid`` for a registry holding
    ``fedbuff``, ``server_update_grid`` for any other); each lane's rule
    is a ``(G,)`` global ``AGGREGATOR_ORDER`` index on the device, built
    once per group.  The lanes run in LANE GROUPS, in run order, each
    stacked and swept on its own (``lanes_per_group``: as many lanes as
    ``GRID_ROW_BYTES`` and ``GRID_PAIR_BYTES`` allow), so the round's
    ``(lanes * K, P)`` trainer rows and ``(lanes, N, N)`` pair tables stay
    bounded whatever G; a lane's arithmetic does not depend on its group;
  * otherwise (more than 4,096 clients: the fleet runs, whose neighbour
    search and fusion are the windowed and compact forms, one lane at a
    time) the LANE LOOP: each lane's round in turn through the one-lane
    round step (two ``rttg_latency`` launches, one ``rsu_reduce`` a chunk
    and one server-kernel launch a lane).

Both run the same semantics:

  * ONE round step and ONE warm-up serve the whole engine, built for its
    strategies and its aggregator registry: the cohort width is
    ``cohort_size_for(fl, strategies)`` (with ``greedy`` among them every
    lane trains N slots), and the registry picks the server path (only
    ``("fedavg",)`` keeps ``fedavg_reduce`` + the AXPY; a registry holding
    ``fedbuff`` sends every lane through ``server_update_buffered``, or its
    grid form, ``fedavg`` lanes too);
  * ``RoundData`` rows are de-duplicated (within a lane group): one per
    unique (strategy, seed, ``scenarios.data_signature``), built from the
    first lane of its triple
    and read by reference by every lane of it (the experiment key never
    folds the scenario, so only the platoon spawn changes a lane's home
    regions);
  * the lane loop keeps the lanes' states as a list, one ``RoundState`` a
    lane, each replaced by its round's result (rounds outer, lanes inner);
    the batched round keeps one ``rounds.stack_states`` stack, the unique
    data rows stacked ``(M, ...)`` and each lane's ``(G,)`` row index,
    read at each gather (no per-lane copy of the client shards);
  * each lane's ``ScenarioParams`` is built once per lane group, so
    ``rttg_latency``'s per-object operand cache holds for the whole run;
    ``stack_scenarios`` refuses a grid whose static fields differ, as the
    reference's stacking does, and its ``lane_view`` is the batched
    round's scenario (``rttg_latency_grid``'s operand built once from it);
  * eval runs every ``eval_every`` rounds and on the last; re-clustering
    every ``recluster_every`` rounds; both schedules are host flags;
  * each round's ``(G,)`` metrics are written into ``(G, rounds)`` device
    tensors, one op a field: nothing is read back to the host until
    ``GridResult.records`` or ``final_accuracy`` is called.

With a ``mesh`` (``launch.mesh.make_grid_mesh()``: a tuple of devices, one
a shard) the grid's lanes are SHARDED over the mesh's devices, as the
reference's ``shard_map`` over its ``("data",)`` mesh shards them
(``grid_shards``):

  * the runs are padded to a multiple of the shard count by repeating the
    last run and cut into contiguous shards of ``(G + pad) / n`` lanes;
  * each shard builds its lanes' states, ``ScenarioParams`` and
    de-duplicated ``RoundData`` rows on its own device only (shard-local
    rows: ``last_data_plan`` reports the placement, as
    ``partition.shard_local_rows`` plans it for the reference), cuts its
    lanes into lane groups by ``lanes_per_group()`` (so the budgets hold per
    device) and sweeps them there, through the batched round or the lane
    loop as the engine's path says;
  * each shard's ``(per, rounds)`` metrics are gathered on the mesh's first
    device in run order and the padded lanes dropped.

A lane's arithmetic does not depend on its shard or its process, so every
lane is the unsharded grid's bit for bit.  Without a mesh the engine runs
the same code on one shard, its own device.  Two lanes run the shards, both
through the same shard body (``_sweep_groups`` on the shard's slice of the
padded runs):

  * the PROCESS LANE (``processes``; by default on a mesh of distinct
    devices, ``make_grid_mesh()`` on two or more cards): each shard is swept
    by a worker process of its own (``utils.procs.ShardPool``: spawned, its
    card current, the caller's torch thread count, its own engine built
    from this one's constructor arguments and kept warm for the pool's
    life), all at once.  Each worker sends back its shard's ``(per,
    rounds)`` metrics on the CPU (exact copies), its launch-counter deltas
    (added to this process's counters), its sweep's seconds and its card's
    memory (``last_shard_stats``), then returns its cached blocks to the
    card, which it may share with other processes.  The pool starts at the
    first such ``run_grid`` (``pool_start_s``, the kernel library built
    first in this process) and ends on ``close()``, at the end of ``with
    ExperimentEngine(...)`` or at exit.  A worker that raises or dies makes
    ``run_grid`` raise and closes the pool: nothing falls back to the
    in-process turn.  One process a card: threads of one process contend
    for the interpreter lock at every op (one thread a card issued the same
    ops several times slower than one thread issuing them all, PERF.md);
  * the IN-PROCESS TURN (a mesh that repeats a device, such as
    ``GridMesh((cuda:0, cuda:0))`` or a CPU mesh, unless ``processes=True``):
    the calling thread sweeps the shards in mesh order, each with its card
    current; every kernel wrapper launches on its operands' card
    (``kernels.on_card``).  A grid round issues about as many ops for 6
    lanes as for 24, so this turn is slower than one card on every grid
    measured (PERF.md).

Lane groups already bound what a card holds, so a grid of several lane
groups peaks on every card of the mesh as on one card.  Not ported:
``partition_on_device`` / ``init_on_device``, which choose between XLA
placements: the port always builds state and data on the shard's device.

Usage:

    eng = ExperimentEngine(model_cfg, fl_cfg, "mnist",
                           strategies=("contextual", "gossip"),
                           aggregators=("fedavg", "fedadam"), device="cuda")
    result = eng.run_grid(seeds=(0, 1), scenarios=("ring", "rush_hour"),
                          rounds=40, eval_every=5)
    result.records(strategy="contextual", seed=0, scenario="ring",
                   aggregator="fedadam")
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.config import FLConfig, ModelConfig, TrafficConfig
from repro_torch.core.scenarios import (
    ScenarioParams,
    data_signature,
    lane_view,
    scenario_config,
    scenario_params,
    stack_scenarios,
)
from repro_torch.fl.aggregators import AGGREGATOR_ORDER, validate_aggregators
from repro_torch.fl.partition import shard_local_rows
from repro_torch.fl.rounds import (
    RoundData,
    RoundMetrics,
    RoundRecord,
    RoundState,
    cohort_size_for,
    derive_regions,
    experiment_key,
    grid_round_fits,
    init_state_for_key,
    make_grid_round_step,
    make_grid_warmup,
    make_round_data,
    make_round_step,
    make_warmup,
    metrics_to_records,
    stack_rows,
    stack_states,
)
from repro_torch.kernels import add_launches, launch_counts
from repro_torch.kernels import build as kbuild
from repro_torch.models import build_model
from repro_torch.utils.device import GridMesh, resolve_device
from repro_torch.utils.procs import ShardPool
from repro_torch.utils.pytree import flat_size_of, tree_bytes

ScenarioLike = Union[str, TrafficConfig]

_INT_METRICS = ("round", "n_selected", "n_succeeded", "n_buffered", "n_drained")

# The batched path's lane groups take as many lanes as both budgets allow
# (at least one).  GRID_ROW_BYTES bounds one (lanes * rows, P) fp32 tensor
# of the round's trainer, rows the cohort width K (the chunk B on the
# streamed lanes): its start, parameters and gradients are fp32 in either
# precision, and ~6 such tensors live at its peak.  6 GiB: at fl-mnist-mlp's
# P = 159,010 and N = 4,096 it admits 24 lanes without greedy (K = 410,
# 260.8 MB a lane) and 2 with it (K = N, 2.6 GB a lane; a group of 2 peaked
# at 32.5 GiB on an H100).  GRID_PAIR_BYTES bounds the fusion's (5, lanes, N, N)
# fp32 table, 20 N^2 bytes a lane (335.5 MB at N = 4,096), which the
# neighbour search's (lanes, N, N) distances, sorted values and int64
# indices match: 4 GiB, 12 lanes at N = 4,096 and 51 at N = 2,048.
GRID_ROW_BYTES = 6 << 30
GRID_PAIR_BYTES = 4 << 30


def shards_in_processes(mesh: Sequence[torch.device], processes: Optional[bool] = None) -> bool:
    """Whether a grid sharded over ``mesh`` sweeps each shard in a worker
    process of its own: never on a mesh of one shard; on a larger one as
    ``processes`` says, and where it is None when no device repeats (every
    card once, ``make_grid_mesh()``)."""
    if len(mesh) < 2:
        return False
    return len(set(mesh)) == len(mesh) if processes is None else bool(processes)


def _eval_flags(rounds: int, eval_every: int) -> List[bool]:
    return [(r + 1) % max(eval_every, 1) == 0 or r == rounds - 1 for r in range(rounds)]


def _recluster_flags(rounds: int, recluster_every: int) -> List[bool]:
    every = max(recluster_every, 1)
    return [(r + 1) % every == 0 for r in range(rounds)]


@dataclasses.dataclass
class _Lanes:
    """A grid's lanes as the lane loop keeps them: each lane's state,
    scenario, strategy and aggregator index, and its data row."""

    states: List[RoundState]
    scns: List[ScenarioParams]
    strategy_idx: List[int]
    aggregator_idx: List[int]
    rows: List[RoundData]  # one per unique (strategy, seed, data_signature)
    row_idx: List[int]
    device: torch.device


@dataclasses.dataclass
class _GridLanes:
    """A grid's lanes as the batched round keeps them: one stacked state,
    the scenarios' lane view, and ``(G,)`` strategy, rule and row indices on
    the device (the rule a global ``AGGREGATOR_ORDER`` index, the row one
    into the stacked rows)."""

    state: RoundState  # every device leaf (G, ...)
    scn: ScenarioParams  # lane_view: every lane field (G, 1)
    strategy_idx: torch.Tensor
    rule_idx: torch.Tensor  # (G,) int32
    rows: RoundData  # (M, ...), one per unique (strategy, seed, data_signature)
    row_idx: torch.Tensor
    device: torch.device


@dataclasses.dataclass
class GridResult:
    """Stacked metrics for a flat experiment grid.

    ``runs`` rows are (strategy, aggregator, seed, scenario name).  The
    lookups take ``aggregator`` as a defaulted trailing keyword: omitted, it
    resolves to the grid's sole aggregator, and a multi-aggregator lookup
    that omits it fails with the axis' values.
    """

    metrics: RoundMetrics  # leaves (G, rounds), on the run's device
    runs: List[Tuple[str, str, int, str]]  # (strategy, aggregator, seed, scenario)

    def _resolve_aggregator(self, aggregator: Optional[str]) -> str:
        if aggregator is not None:
            return aggregator
        axis = sorted({r[1] for r in self.runs})
        if len(axis) != 1:
            raise ValueError(
                "this grid swept multiple aggregators — pass aggregator= "
                f"explicitly (one of: {', '.join(axis)})"
            )
        return axis[0]

    def index_of(self, strategy: str, seed: int, scenario: str,
                 aggregator: Optional[str] = None) -> int:
        aggregator = self._resolve_aggregator(aggregator)
        return self.runs.index((strategy, aggregator, seed, scenario))

    def records(self, strategy: str, seed: int, scenario: str,
                aggregator: Optional[str] = None) -> List[RoundRecord]:
        g = self.index_of(strategy, seed, scenario, aggregator)
        return metrics_to_records(RoundMetrics(*[x[g] for x in self.metrics]))

    def final_accuracy(self) -> Dict[Tuple[str, str, int, str], float]:
        acc = self.metrics.test_acc[:, -1].cpu().tolist()
        return {run: float(acc[g]) for g, run in enumerate(self.runs)}


class ExperimentEngine:
    """One round step for a fixed (model, FL config, strategies, registry),
    run over grids of experiments on ``device``.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; raises when CUDA is
    asked for and no card is present.  ``warmup=False`` skips the
    deadline-rule bootstrap, which trains all N clients once (the fleet lane
    cannot afford it).  ``batched`` says which path ``run_grid`` takes (the
    module docstring), decided here from the config alone: the batched round
    for every engine of N <= ``messages.DENSE_MAX_N`` (4,096), in lane
    groups of ``lanes_per_group()``, the lane loop above.

    ``mesh``: a ``GridMesh`` (``launch.mesh.make_grid_mesh()``) or a sequence
    of devices; ``run_grid`` shards the grid's lanes over it (the module
    docstring), and ``device`` defaults to the mesh's first device, where
    the results are gathered.  Without one the mesh is ``(device,)``.
    ``processes``: whether each shard runs in a worker process of its own
    (``shards_in_processes``: None takes the process lane on a mesh of
    distinct devices, True on any mesh of more than one shard, False
    never).  ``last_data_plan`` (after a sharded ``run_grid``): the
    shard-local RoundData placement, ``{"total_rows", "rows_per_shard",
    "n_shards"}``, the reference's for the same grid and shard count;
    ``None`` unsharded and on a mesh of one.  ``last_shard_stats`` (after a
    ``run_grid`` on the process lane, else None): a dict a shard, in mesh
    order, of its ``device``, worker ``pid``, ``lanes``, ``sweep_s`` and card
    ``held_bytes`` / ``peak_bytes`` (None on the CPU); ``pool_start_s``: the
    pool's start-up seconds.  ``close()`` (or ``with``) ends the workers.
    """

    def __init__(
        self,
        model_cfg: ModelConfig,
        fl_cfg: FLConfig,
        dataset: str,
        strategies: Sequence[str] = ("contextual",),
        num_clients: Optional[int] = None,
        aggregators: Sequence[str] = ("fedavg",),
        warmup: bool = True,
        device=None,
        mesh=None,
        processes=None,
    ):
        if device is None:
            device = "cuda" if mesh is None else GridMesh(mesh)[0]
        self.device = resolve_device(device)
        self.mesh = GridMesh((self.device,) if mesh is None else mesh)
        self.processes = shards_in_processes(self.mesh, processes)
        self.last_data_plan = None
        self.last_shard_stats = None
        self.pool_start_s = None
        self._pool = None
        if num_clients is not None:
            fl_cfg = dataclasses.replace(fl_cfg, num_clients=num_clients)
        # what a worker process builds its own engine from (the process lane)
        self._spec = dict(model_cfg=model_cfg, fl_cfg=fl_cfg, dataset=dataset,
                          strategies=tuple(strategies), aggregators=tuple(aggregators),
                          warmup=warmup)
        self.fl = fl_cfg
        self.warmup_enabled = bool(warmup)
        self.dataset = dataset
        self.strategies = tuple(strategies)
        self.aggregators = validate_aggregators(aggregators)
        self.api = build_model(model_cfg)
        self.cohort_size = cohort_size_for(fl_cfg, self.strategies)
        self.param_spec = self.api.spec
        self.model_bytes = float(tree_bytes(self.param_spec))
        self._round_step = make_round_step(
            self.api.loss, self.fl, self.cohort_size, self.model_bytes, self.param_spec,
            strategies=self.strategies, aggregators=self.aggregators,
        )
        self._warmup = make_warmup(self.api.loss, self.fl, self.param_spec)
        self.batched = grid_round_fits(self.fl, self.aggregators)
        if self.batched:
            self._grid_step = make_grid_round_step(
                self.api.loss, self.fl, self.cohort_size, self.model_bytes, self.param_spec,
                strategies=self.strategies, aggregators=self.aggregators)
            self._grid_warmup = make_grid_warmup(self.api.loss, self.fl, self.param_spec)

    def _traffic_of(self, scenario: ScenarioLike) -> TrafficConfig:
        if isinstance(scenario, TrafficConfig):
            tc = scenario
        else:
            tc = scenario_config(scenario, num_vehicles=self.fl.num_clients)
        if tc.num_vehicles != self.fl.num_clients:
            raise ValueError(
                "every FL client is a CAV: num_clients "
                f"({self.fl.num_clients}) must equal num_vehicles "
                f"({tc.num_vehicles})"
            )
        return tc

    def init_run(self, strategy: str, seed: int, scenario: ScenarioLike):
        """One lane's (state, data, scn, strategy index), before any warm-up,
        all on the engine's device."""
        scn = scenario_params(self._traffic_of(scenario), self.device)
        key = experiment_key(self.dataset, strategy, seed)
        state, regions = init_state_for_key(self.api, self.fl, scn, key, self.device)
        data = make_round_data(key, self.dataset, self.fl, regions, self.device)
        return state, data, scn, self.strategies.index(strategy)

    def _row_index(self, runs) -> List[int]:
        """Each lane's data row among ``runs``: client shards depend on
        (strategy, seed) and the spawn layout's signature, never on the
        aggregator, so one row per unique (strategy, seed, data_signature),
        numbered in order of first appearance."""
        row_of = {}
        return [row_of.setdefault((strategy, seed, data_signature(self._traffic_of(sc))),
                                  len(row_of))
                for strategy, _, seed, sc in runs]

    def _lane_list(self, runs, warm: bool = True, device=None) -> _Lanes:
        """Every lane of ``runs`` initialized (and, with ``warm`` and the
        engine's warm-up on, warmed up one lane at a time) on ``device`` (the
        engine's by default), as the lane loop keeps them."""
        dev, fl = self.device if device is None else device, self.fl
        scns = [scenario_params(self._traffic_of(run[3]), dev) for run in runs]
        stack_scenarios(scns)  # refuses lanes whose static fields differ
        row_idx = self._row_index(runs)
        states, sidx, aidx, rows = [], [], [], []
        for (strategy, aggregator, seed, _), scn, row in zip(runs, scns, row_idx):
            key = experiment_key(self.dataset, strategy, seed)
            if row == len(rows):  # the row's first lane builds it from its scenario
                rows.append(make_round_data(key, self.dataset, fl, derive_regions(key, scn), dev))
            state = init_state_for_key(self.api, fl, scn, key, dev)[0]
            if warm and self.warmup_enabled:
                state = self._warmup(state, rows[row])
            states.append(state)
            sidx.append(self.strategies.index(strategy))
            aidx.append(self.aggregators.index(aggregator))
        return _Lanes(states, scns, sidx, aidx, rows, row_idx, dev)

    def _lanes(self, runs, device=None) -> Union[_Lanes, _GridLanes]:
        """Every lane of ``runs`` initialized and warmed up on ``device`` (the
        engine's by default), as this engine's path keeps them (stacked for
        the batched round)."""
        if not self.batched:
            return self._lane_list(runs, device=device)
        lanes = self._lane_list(runs, warm=False, device=device)
        dev = lanes.device
        row_idx = torch.tensor(lanes.row_idx, device=dev)
        rows = stack_rows(lanes.rows)
        state = stack_states(lanes.states)
        if self.warmup_enabled:
            state = self._grid_warmup(state, rows, row_idx)
        rules = [AGGREGATOR_ORDER.index(self.aggregators[a]) for a in lanes.aggregator_idx]
        return _GridLanes(state, lane_view(stack_scenarios(lanes.scns)),
                          torch.tensor(lanes.strategy_idx, device=dev),
                          torch.tensor(rules, dtype=torch.int32, device=dev), rows, row_idx,
                          dev)

    def grid_shards(self) -> int:
        """How many shards ``run_grid`` cuts a grid into: the mesh's size (1
        without a mesh)."""
        return len(self.mesh)

    def lanes_per_group(self) -> int:
        """Lanes of one lane group on the batched path: as many as
        ``GRID_ROW_BYTES`` and ``GRID_PAIR_BYTES`` allow, at least one."""
        rows = self.fl.client_block or self.cohort_size
        row_bytes = rows * flat_size_of(self.param_spec) * 4
        pair_bytes = 5 * 4 * self.fl.num_clients ** 2
        return max(1, min(GRID_ROW_BYTES // row_bytes, GRID_PAIR_BYTES // pair_bytes))

    def _groups(self, runs) -> List[list]:
        """``runs`` cut into lane groups in run order: one group on the lane
        loop, ``lanes_per_group()`` lanes each (the last maybe fewer) on the
        batched path."""
        size = self.lanes_per_group() if self.batched else len(runs)
        return [runs[lo:lo + size] for lo in range(0, len(runs), size)]

    def _grid_round(self, lanes, do_eval: bool, do_recluster: bool) -> RoundMetrics:
        """One round of every lane, each lane's state replaced by its new
        one; the lanes' ``(G,)`` metrics (device tensors).  Stacked lanes
        take the batched round, a lane list the lane loop."""
        if isinstance(lanes, _GridLanes):
            lanes.state, m = self._grid_step(lanes.state, lanes.scn, lanes.strategy_idx,
                                             lanes.rule_idx, lanes.rows, lanes.row_idx, do_eval,
                                             do_recluster)
            return m
        out = []
        for g, scn in enumerate(lanes.scns):
            lanes.states[g], m = self._round_step(
                lanes.states[g], scn, lanes.strategy_idx[g], lanes.aggregator_idx[g],
                lanes.rows[lanes.row_idx[g]], do_eval, do_recluster)
            out.append(m)
        return RoundMetrics(*[torch.stack(xs) for xs in zip(*out)])

    def _sweep(self, lanes, rounds: int, eval_every: int) -> RoundMetrics:
        """``rounds`` rounds of every lane: ``(G, rounds)`` metrics on the
        device, nothing read back."""
        G = len(lanes.row_idx)
        metrics = RoundMetrics(*[
            torch.empty((G, rounds), device=lanes.device,
                        dtype=torch.int32 if f in _INT_METRICS else torch.float32)
            for f in RoundMetrics._fields])
        flags = zip(_eval_flags(rounds, eval_every),
                    _recluster_flags(rounds, self.fl.recluster_every))
        for r, (do_eval, do_recluster) in enumerate(flags):
            for buf, x in zip(metrics, self._grid_round(lanes, do_eval, do_recluster)):
                buf[:, r].copy_(x)
        return metrics

    def run_grid(
        self,
        seeds: Sequence[int],
        scenarios: Sequence[ScenarioLike],
        rounds: int,
        strategies: Optional[Sequence[str]] = None,
        aggregators: Optional[Sequence[str]] = None,
        eval_every: int = 1,
    ) -> GridResult:
        """Run the (strategy x aggregator x seed x scenario) grid."""
        strategies = tuple(strategies) if strategies is not None else self.strategies
        unknown = set(strategies) - set(self.strategies)
        if unknown:
            raise ValueError(
                f"strategies {sorted(unknown)} not covered by this engine's "
                f"cohort size; construct it with strategies={sorted(set(self.strategies) | unknown)}"
            )
        aggregators = (
            tuple(aggregators) if aggregators is not None else self.aggregators
        )
        unknown = set(aggregators) - set(self.aggregators)
        if unknown:
            raise ValueError(
                f"aggregators {sorted(unknown)} not in this engine's compiled "
                f"registry; construct it with "
                f"aggregators={sorted(set(self.aggregators) | unknown)}"
            )
        runs = list(itertools.product(strategies, aggregators, seeds, scenarios))
        # refuse lanes whose static fields differ, whichever groups they fall in
        stack_scenarios([scenario_params(self._traffic_of(sc), self.device) for sc in scenarios])
        metrics = self._run_sharded(runs, rounds, eval_every)
        scenarios = list(scenarios)

        def _label(sc):
            return sc if isinstance(sc, str) else f"custom-{scenarios.index(sc)}"

        labels = [(strategy, aggregator, seed, _label(sc))
                  for strategy, aggregator, seed, sc in runs]
        return GridResult(metrics=metrics, runs=labels)

    def _sweep_groups(self, runs, rounds: int, eval_every: int, device) -> List[RoundMetrics]:
        """``runs`` in lane groups on ``device``: each group set up, swept
        and dropped before the next (one group's stack on the device at a
        time); the groups' metrics in run order."""
        return [self._sweep(self._lanes(group, device), rounds, eval_every)
                for group in self._groups(runs)]

    def _cat(self, parts: List[RoundMetrics]) -> RoundMetrics:
        """Lane-group metrics joined in order on the engine's device."""
        return RoundMetrics(*[torch.cat([x.to(self.device) for x in xs]) for xs in zip(*parts)])

    def _run_sharded(self, runs, rounds: int, eval_every: int) -> RoundMetrics:
        """``runs`` sharded over the mesh (the module docstring; without a
        mesh, one shard on the engine's device): padded by repeating the last
        run, cut into contiguous shards, each shard's lane groups swept on its
        device, the shards in mesh order on the calling thread or each in its
        worker process (``processes``); the metrics gathered on the engine's
        device in run order, padding dropped.  Sets ``last_data_plan`` (None
        on one shard) and ``last_shard_stats`` (None off the process lane)."""
        n, G = len(self.mesh), len(runs)
        padded = runs + runs[-1:] * (-G % n)
        per = len(padded) // n
        shards = [padded[s * per:(s + 1) * per] for s in range(n)]
        self.last_data_plan = self.last_shard_stats = None
        if n > 1:
            row_idx = self._row_index(padded)
            shard_rows, _ = shard_local_rows(row_idx, n)
            self.last_data_plan = {"total_rows": max(row_idx) + 1,
                                   "rows_per_shard": int(shard_rows.shape[1]), "n_shards": n}
        if self.processes:
            parts = self._sweep_in_processes(shards, rounds, eval_every)
        else:
            parts = []
            for shard, dev in zip(shards, self.mesh):
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    parts += self._sweep_groups(shard, rounds, eval_every, dev)
        metrics = self._cat(parts)
        return RoundMetrics(*[x[:G] for x in metrics])

    def _sweep_in_processes(self, shards, rounds: int, eval_every: int) -> List[RoundMetrics]:
        """Each shard swept by its worker process (``_shard_sweep``), all at
        once; the shards' CPU metrics in mesh order.  The workers' launches
        are added to this process's counters; ``last_shard_stats`` gets each
        worker's device, pid, lanes, sweep seconds and card memory (held
        when the call began, and the peak since; None on the CPU)."""
        args = [(shard, rounds, eval_every, self.batched) for shard in shards]
        try:
            pickle.dumps(args)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise TypeError("run_grid on the process lane sends each worker its runs, and "
                            f"they do not pickle (a custom TrafficConfig scenario must): {e}"
                            ) from e
        pool = self._shard_pool()
        try:
            outs = pool.run(_shard_sweep, args)
        finally:
            if not pool.alive:
                self._pool = None
        deltas: Dict[tuple, int] = {}
        for out in outs:
            for k, v in out["launches"].items():
                deltas[k] = deltas.get(k, 0) + v
        add_launches(deltas)
        self.last_shard_stats = [
            dict(device=str(dev), pid=pid, lanes=len(shard), sweep_s=out["sweep_s"],
                 held_bytes=out["held_bytes"], peak_bytes=out["peak_bytes"])
            for dev, pid, shard, out in zip(self.mesh, pool.pids, shards, outs)]
        return [out["metrics"] for out in outs]

    def _shard_pool(self) -> ShardPool:
        """The engine's workers, one a shard in mesh order, started at first
        use (the kernel library built first, here, when the mesh is on
        CUDA); ``pool_start_s`` their start-up."""
        if self._pool is None:
            if any(d.type == "cuda" for d in self.mesh):
                kbuild.build()
            self._pool = ShardPool(self.mesh, init=_start_shard, init_args=(self._spec,))
            self.pool_start_s = self._pool.start_s
        return self._pool

    def close(self) -> None:
        """End the engine's worker processes, if any (idempotent); the next
        sharded ``run_grid`` on the process lane starts new ones."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    def __enter__(self) -> "ExperimentEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run_single(
        self,
        strategy: str,
        seed: int,
        scenario: ScenarioLike = "ring",
        rounds: int = 40,
        eval_every: int = 1,
        aggregator: Optional[str] = None,
    ) -> List[RoundRecord]:
        """One experiment: a grid of one lane."""
        result = self.run_grid(
            seeds=(seed,), scenarios=(scenario,), rounds=rounds,
            strategies=(strategy,),
            aggregators=(aggregator or self.aggregators[0],),
            eval_every=eval_every,
        )
        return metrics_to_records(RoundMetrics(*[x[0] for x in result.metrics]))


def _start_shard(worker, spec: dict) -> ExperimentEngine:
    """A worker process's engine (``utils.procs.ShardPool``'s ``init``): the
    caller's constructor arguments on the worker's device, without a mesh;
    kept for the pool's life, so its round steps and caches stay warm."""
    return ExperimentEngine(**spec, device=worker.device)


def _shard_sweep(worker, runs, rounds: int, eval_every: int, batched: bool) -> dict:
    """A worker's shard: ``runs`` swept in lane groups by the worker's
    engine (``_sweep_groups``, the in-process turn's body) on the path the
    caller's engine takes.  -> its ``(per, rounds)`` metrics on the CPU, its
    launch-counter deltas, the sweep's seconds, and the card's bytes held
    when the call began and peak since (None on the CPU).  Then the worker
    returns its cached blocks to the card: processes share a card (the
    caller and the worker on cuda:0, two workers of one card), and a grid
    of several lane groups leaves about twice its peak cached."""
    eng, dev = worker.state, worker.device
    eng.batched = batched
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev) if cuda else None
    before = launch_counts()
    t0 = time.perf_counter()
    parts = eng._sweep_groups(runs, rounds, eval_every, dev)
    metrics = RoundMetrics(*[torch.cat(xs).cpu() for xs in zip(*parts)])  # waits for the card
    sweep_s = time.perf_counter() - t0
    after = launch_counts()
    out = dict(metrics=metrics, sweep_s=sweep_s, held_bytes=held,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
               launches={k: after[k] - before[k] for k in after if after[k] != before[k]})
    if cuda:
        torch.cuda.empty_cache()
    return out
