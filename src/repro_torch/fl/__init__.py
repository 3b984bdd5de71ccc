"""The FL runtime: partitioning, clients, server, the round core, the
experiment engine and the per-experiment simulation.

``ExperimentEngine``, ``GridResult``, ``FLSimulation`` and
``time_to_accuracy`` load on first use: the kernels import
``fl.aggregators``, and the engine imports the kernels.
"""

_EXPORTS = {"ExperimentEngine": "engine", "GridResult": "engine",
            "FLSimulation": "simulation", "time_to_accuracy": "simulation"}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
