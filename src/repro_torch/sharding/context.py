"""The ambient sharding context (``repro.sharding.context``).

``activation_sharding(mesh, rules, rank)`` installs the mesh, the rule table
and the calling process's ``sharding.shard.Rank`` for the block.  The LM
engine reads it: outside such a block (the unsharded path, the tests of one
process) ``current_rank()`` is None and nothing changes; inside it,
``models/transformer.py`` runs its sharded forward on the rank's local
blocks and ``models/moe.py::moe_ffn`` takes the expert-parallel
``moe_ffn_local`` where the mesh's ``model`` axis has more than one rank,
as the reference's ``moe_ffn`` reads its ``_STATE``.

``act_shard`` stays a no-op.  In the reference it pins an activation's
layout for GSPMD, which then inserts the collectives; here every layout is
explicit (each rank holds its own block of every leaf) and the forward
calls its collectives itself, so there is no layout to pin.
"""
from __future__ import annotations

import contextlib

_STATE: dict = {"mesh": None, "rules": None, "rank": None}


@contextlib.contextmanager
def activation_sharding(mesh, rules, rank=None):
    prev = dict(_STATE)
    _STATE["mesh"], _STATE["rules"], _STATE["rank"] = mesh, rules, rank
    try:
        yield
    finally:
        _STATE.update(prev)


def current_rank():
    """The installed ``Rank``, or None outside ``activation_sharding``."""
    return _STATE["rank"]


def act_shard(x, *logical_axes):
    """``x`` unchanged (see the module docstring)."""
    return x
