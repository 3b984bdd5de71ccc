"""The paper's contribution: contextual client selection for FL in C-ITS.

Pipeline stages (paper Fig. 2), as in ``repro.core``:
  1. V2X message fusion          -> core.fusion  (CAM/CPM -> RTTG)
  2. RTTG prediction             -> core.trajectory
  3. Data-level client grouping  -> core.clustering (the pairwise-cosine
                                    Gram is the ``pairwise_cosine`` kernel)
  4. Network-level election      -> core.selection (Fast-gamma)

The traffic digital twin lives in ``core.twin``, the radio / latency model
in ``core.network``, and ``ContextualSelector`` runs the four stages one
call at a time.  The names are ``repro.core.__all__``; ``stack_scenarios``
stacks the lanes of the experiment engine's grid.
"""
from repro_torch.core.twin import TrafficTwin, TwinState, advance_twin, init_twin_state, twin_step
from repro_torch.core.scenarios import (SCENARIOS, ScenarioParams, scenario_config,
                                        scenario_params, stack_scenarios)
from repro_torch.core.messages import emit_cams, emit_cpms
from repro_torch.core.fusion import fuse_messages
from repro_torch.core.rttg import RTTG, build_rttg
from repro_torch.core.trajectory import predict_rttg
from repro_torch.core.network import connectivity, latency_model
from repro_torch.core.clustering import kmeans_cluster, pairwise_cosine, update_sketch
from repro_torch.core.selection import STRATEGIES, select_clients
from repro_torch.core.pipeline import ContextualSelector

__all__ = [
    "TrafficTwin",
    "TwinState",
    "advance_twin",
    "init_twin_state",
    "twin_step",
    "SCENARIOS",
    "ScenarioParams",
    "scenario_config",
    "scenario_params",
    "stack_scenarios",
    "emit_cams",
    "emit_cpms",
    "fuse_messages",
    "RTTG",
    "build_rttg",
    "predict_rttg",
    "latency_model",
    "connectivity",
    "update_sketch",
    "pairwise_cosine",
    "kmeans_cluster",
    "select_clients",
    "STRATEGIES",
    "ContextualSelector",
]
