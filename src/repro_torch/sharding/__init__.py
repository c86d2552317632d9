"""Sharded execution on ``torch.distributed``: placement rules, the
logical-axis trees of the train state, and :class:`DistContext`. Port of
``repro/sharding``."""
from .context import DistContext
from .rules import (P, PartitionSpec, batch_spec, resolve_spec,
                    to_placements, tree_shardings)
from .state import cache_axes, params_axes, state_axes

__all__ = ["DistContext", "P", "PartitionSpec", "batch_spec", "cache_axes",
           "params_axes", "resolve_spec", "state_axes", "to_placements",
           "tree_shardings"]
