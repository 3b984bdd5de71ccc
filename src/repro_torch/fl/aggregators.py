"""Server aggregation rules (``repro.fl.aggregators``): the fedavg lane.

The JAX registry order is kept so a later slice can add the moment rules
(``fedavgm`` / ``fedadam`` / ``fedyogi``), ``stale`` and ``fedbuff``
without renumbering; only ``fedavg`` runs in the port so far.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

AGGREGATOR_ORDER: Tuple[str, ...] = (
    "fedavg", "fedavgm", "fedadam", "fedyogi", "stale", "fedbuff"
)
PORTED_AGGREGATORS: Tuple[str, ...] = ("fedavg",)


def validate_aggregators(names: Sequence[str]) -> Tuple[str, ...]:
    """Normalize; fail fast on unknown names and on rules not ported yet."""
    names = tuple(names)
    unknown = set(names) - set(AGGREGATOR_ORDER)
    if unknown:
        raise ValueError(
            f"unknown aggregator(s) {sorted(unknown)}; registered catalog: "
            f"{', '.join(AGGREGATOR_ORDER)}"
        )
    missing = set(names) - set(PORTED_AGGREGATORS)
    if missing:
        raise NotImplementedError(
            f"aggregator(s) {sorted(missing)} are not ported yet (see ROADMAP.md); "
            f"the port runs {', '.join(PORTED_AGGREGATORS)}"
        )
    return names


def init_opt_vectors(params_vec: torch.Tensor):
    """Zero (m, v) server-moment vectors matching the flat (P,) carry."""
    z = torch.zeros_like(params_vec, dtype=torch.float32)
    return z, z.clone()
