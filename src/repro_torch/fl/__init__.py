"""The FL runtime: partitioning, clients, server, the aggregator registry,
the round core, the experiment engine and the per-experiment simulation.

The names are ``repro.fl.__all__``, with ``init_state_for_key`` in the
place of the reference's ``init_state_traced`` (the port builds a lane's
state eagerly from its folded key; nothing is traced).  Every name loads on
first use: the kernels import ``fl.aggregators``, and the round core and
the engine import the kernels.
"""

_EXPORTS = {
    **dict.fromkeys(("AGGREGATOR_ORDER", "ServerHP", "apply_rule", "staleness_scale",
                     "validate_aggregators"), "aggregators"),
    **dict.fromkeys(("partition_clients", "partition_labels", "client_images",
                     "client_sample_counts", "make_test_set"), "partition"),
    "make_local_trainer": "client",
    "fedavg_aggregate": "server",
    **dict.fromkeys(("RoundData", "RoundMetrics", "RoundRecord", "RoundState",
                     "STRATEGY_ORDER", "experiment_key", "init_experiment", "init_state",
                     "init_state_for_key", "regions_of", "make_round_data", "make_round_step",
                     "make_warmup", "metrics_to_records"), "rounds"),
    "ExperimentEngine": "engine",
    "GridResult": "engine",
    "FLSimulation": "simulation",
    "time_to_accuracy": "simulation",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
