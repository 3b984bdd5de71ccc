"""Sharding of the port's LM zoo over a ``("data", "model")`` mesh of ranks
(``repro.sharding``): the reference's rule tables and spec resolution
(``rules``), the ambient context (``context``) and the runtime pieces the
reference leaves to GSPMD (``shard``: blocks, the sharded draw, a rank's
layout, the collectives).  The JAX-only names (``shard_map``,
``SHARD_MAP_NO_CHECK``, ``Param``, ``split_params``, ``tree_shardings``)
have no counterpart."""
from repro_torch.sharding.context import act_shard, activation_sharding, current_rank
from repro_torch.sharding.rules import (
    SERVE_FSDP_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    profile_rules,
    resolve_pspec,
    tree_pspecs,
)
from repro_torch.sharding.shard import Rank, init_shard, leaf_block, make_rank, shard_tree

__all__ = [
    "TRAIN_RULES",
    "SERVE_RULES",
    "SERVE_FSDP_RULES",
    "profile_rules",
    "resolve_pspec",
    "tree_pspecs",
    "activation_sharding",
    "act_shard",
    "current_rank",
    "Rank",
    "leaf_block",
    "shard_tree",
    "init_shard",
    "make_rank",
]
