"""Server aggregation rules on the flat carry layout (``repro.fl.aggregators``).

Every rule is a plain tensor function

    rule(hp, opt, params_vec, delta_vec, round) -> (opt, params_vec)

where ``opt`` is the ``(m, v)`` pair of first/second-moment ``(P,)`` fp32
vectors and ``delta`` the already-reduced weighted cohort update.  The rules
follow Reddi et al., *Adaptive Federated Optimization* (FedAvgM / FedAdam /
FedYogi, no bias correction), with each expression written in the
reference's order so both sides round alike.  ``stale`` and ``fedbuff`` act
in weight space, before the reduction (``staleness_scale`` and the fedbuff
ring in ``fl.rounds``), so their parameter rule is fedavg's AXPY.

The round runs these through the fused ``kernels.server_update`` kernel;
the functions here are its plain version's rule stage and the semantic
contract.  ``apply_rule`` dispatches on the GLOBAL ``AGGREGATOR_ORDER``
index, a Python int in the port (the round resolves it on the host).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

AGGREGATOR_ORDER: Tuple[str, ...] = (
    "fedavg", "fedavgm", "fedadam", "fedyogi", "stale", "fedbuff"
)
STALE_IDX = AGGREGATOR_ORDER.index("stale")
FEDBUFF_IDX = AGGREGATOR_ORDER.index("fedbuff")


class ServerHP(NamedTuple):
    """Server-optimizer hyperparameters (Python floats, from ``FLConfig``)."""

    eta: float = 1.0  # server learning rate (fedavgm/fedadam/fedyogi)
    beta1: float = 0.9  # first-moment decay
    beta2: float = 0.99  # second-moment decay (adaptive rules)
    tau: float = 1e-3  # adaptivity floor added to sqrt(v)


def server_hp(fl) -> ServerHP:
    """The ``ServerHP`` view of an ``FLConfig``."""
    return ServerHP(eta=float(fl.server_lr), beta1=float(fl.server_beta1),
                    beta2=float(fl.server_beta2), tau=float(fl.server_tau))


def validate_aggregators(names: Sequence[str]) -> Tuple[str, ...]:
    """Normalize; fail fast with the registered catalog on unknown names."""
    names = tuple(names)
    unknown = set(names) - set(AGGREGATOR_ORDER)
    if unknown:
        raise ValueError(
            f"unknown aggregator(s) {sorted(unknown)}; registered catalog: "
            f"{', '.join(AGGREGATOR_ORDER)}"
        )
    return names


def init_opt_vectors(params_vec: torch.Tensor):
    """Zero (m, v) server-moment vectors matching the flat (P,) carry."""
    z = torch.zeros_like(params_vec, dtype=torch.float32)
    return z, z.clone()


# ---------------------------------------------------------------------------
# the rules (``rnd`` is reserved for schedule-aware rules; none reads it)
# ---------------------------------------------------------------------------
def _fedavg(hp: ServerHP, opt, params, delta, rnd):
    """Plain FedAvg: one AXPY, moments untouched."""
    return opt, params + delta


def _fedavgm(hp: ServerHP, opt, params, delta, rnd):
    """Server momentum: m <- beta1 m + delta; params <- params + eta m."""
    m, v = opt
    m = hp.beta1 * m + delta
    return (m, v), params + hp.eta * m


def _fedadam(hp: ServerHP, opt, params, delta, rnd):
    """FedAdam: EMA moments, adaptive step eta m / (sqrt(v) + tau)."""
    m, v = opt
    m = hp.beta1 * m + (1.0 - hp.beta1) * delta
    v = hp.beta2 * v + (1.0 - hp.beta2) * (delta * delta)
    return (m, v), params + hp.eta * m / (torch.sqrt(v) + hp.tau)


def _fedyogi(hp: ServerHP, opt, params, delta, rnd):
    """FedYogi: sign-controlled second moment (``sign(0) == 0``)."""
    m, v = opt
    m = hp.beta1 * m + (1.0 - hp.beta1) * delta
    d2 = delta * delta
    v = v - (1.0 - hp.beta2) * d2 * torch.sign(v - d2)
    return (m, v), params + hp.eta * m / (torch.sqrt(v) + hp.tau)


def _stale(hp: ServerHP, opt, params, delta, rnd):
    """Staleness-aware FedAvg: the discount lives in the cohort weights."""
    return opt, params + delta


def _fedbuff(hp: ServerHP, opt, params, delta, rnd):
    """FedBuff async rounds (Nguyen et al.): drained ring slots join the
    reduce as extra weighted rows, so the parameter rule is fedavg's AXPY."""
    return opt, params + delta


_RULES = (_fedavg, _fedavgm, _fedadam, _fedyogi, _stale, _fedbuff)
assert len(_RULES) == len(AGGREGATOR_ORDER)


def apply_rule(agg_idx: int, opt, params, delta, rnd, hp: ServerHP):
    """Run one registered rule by its GLOBAL ``AGGREGATOR_ORDER`` index."""
    return _RULES[int(agg_idx)](hp, opt, params, delta, rnd)


def staleness_scale(per_slot: torch.Tensor, timeout) -> torch.Tensor:
    """Weight discount ``timeout / (timeout + per_slot)`` for stragglers.

    The FedAsync (1 + staleness)^-1 schedule with staleness in deadline
    units.  The denominator is floored at fp32 ``tiny``: ``timeout ==
    per_slot == 0`` gives an exact 0 weight instead of 0/0, and the floor
    is the identity on every normal positive denominator.
    """
    denom = timeout + per_slot
    return timeout / torch.clamp_min(denom, torch.finfo(torch.float32).tiny)
