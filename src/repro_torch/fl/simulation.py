"""FL-over-C-ITS simulation harness (``repro.fl.simulation``).

``FLSimulation`` couples the traffic twin, the selection pipeline and the FL
runtime into one loop over the pure round core (``fl.rounds``): a warm-up
that reports every client's first sketch, then one ``round_step`` per round
with the record read back to the host.  Time is simulated vehicular
wall-clock: a round costs its slowest surviving upload plus compute, or the
timeout when an upload misses the deadline.

The server rule is ``FLConfig.aggregator``, any name of the registered
catalog (``fl.aggregators.AGGREGATOR_ORDER``): the simulation builds a
one-rule registry, so plain ``fedavg`` keeps the ``fedavg_reduce`` step and
every other rule runs the fused ``server_update`` kernel (``fedbuff`` its
buffered form, with the in-flight ring carried in the state).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.config import FLConfig, ModelConfig, TrafficConfig
from repro_torch.core.scenarios import scenario_params
from repro_torch.fl.aggregators import validate_aggregators
from repro_torch.fl.rounds import (
    RoundMetrics,
    RoundRecord,
    cohort_size_for,
    init_state,
    make_round_data,
    make_round_step,
    make_warmup,
    metrics_to_records,
)
from repro_torch.models import build_model
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_bytes


class FLSimulation:
    """One experiment (strategy x scenario x seed) on one device.

    Runs on ``cuda`` unless ``device="cpu"`` is passed; raises when CUDA is
    asked for and no card is present.
    """

    def __init__(self, model_cfg: ModelConfig, fl_cfg: FLConfig,
                 traffic_cfg: TrafficConfig, dataset: str, strategy: str,
                 key: torch.Tensor, device="cuda"):
        self.device = resolve_device(device)
        self.fl, self.traffic, self.strategy = fl_cfg, traffic_cfg, strategy
        self.aggregator = validate_aggregators((fl_cfg.aggregator,))[0]
        self.api = build_model(model_cfg)
        self.scn = scenario_params(traffic_cfg, self.device)
        self.state, regions = init_state(self.api, fl_cfg, self.scn, dataset, strategy,
                                         key, self.device)
        self.data = make_round_data(self.state.key, dataset, fl_cfg, regions, self.device)
        self.param_spec = self.api.spec
        self.model_bytes = float(tree_bytes(self.param_spec))
        self._step = make_round_step(
            self.api.loss, fl_cfg, cohort_size_for(fl_cfg, (strategy,)),
            self.model_bytes, self.param_spec, strategies=(strategy,),
            aggregators=(self.aggregator,),
        )
        self._warmup = make_warmup(self.api.loss, fl_cfg, self.param_spec)

    def warmup_sketches(self) -> None:
        """Deadline-rule bootstrap: every client reports one gradient sketch."""
        self.state = self._warmup(self.state, self.data)

    def step(self) -> RoundMetrics:
        """One round on the device; nothing is read back."""
        self.state, metrics = self._step(self.state, self.scn, 0, 0, self.data, True)
        return metrics

    def run_round(self) -> RoundRecord:
        """One round and its host record."""
        metrics = self.step()
        return metrics_to_records(RoundMetrics(*[x[None] for x in metrics]))[0]

    def run(self, num_rounds: int, time_budget_s: Optional[float] = None,
            verbose: bool = False) -> List[RoundRecord]:
        history = []
        self.warmup_sketches()
        for _ in range(num_rounds):
            rec = self.run_round()
            history.append(rec)
            if verbose:
                print(
                    f"[{self.strategy}] r{rec.round:3d} t={rec.sim_time:8.1f}s "
                    f"dur={rec.duration:6.2f}s sel={rec.n_selected}/{rec.n_succeeded} "
                    f"acc={rec.test_acc:.3f}"
                )
            if time_budget_s is not None and rec.sim_time >= time_budget_s:
                break
        return history


def time_to_accuracy(history: List[RoundRecord], target: float) -> Optional[float]:
    """Simulated seconds until test accuracy first reaches ``target``."""
    for rec in history:
        if rec.test_acc >= target:
            return rec.sim_time
    return None
