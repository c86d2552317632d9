"""Logical-axis trees for the full TrainState (params + optimizer state) and
decode caches — ZeRO: optimizer moments/master inherit parameter shardings;
Adafactor-factored second moments drop the corresponding axis.

Port of ``repro/sharding/state.py``, on the port's ``TrainState`` and its
``meta``-tensor shape trees.
"""
from __future__ import annotations

from typing import Any

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import logical_axes, map_specs
from repro_torch.models.transformer import model_spec
from repro_torch.optim import OptimizerConfig
from repro_torch.optim.adamw import _can_factor
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_map


def params_axes(cfg: ModelConfig) -> Any:
    return logical_axes(model_spec(cfg))


def state_axes(cfg: ModelConfig, ocfg: OptimizerConfig) -> TrainState:
    """Axes tree with the same structure as TrainState."""
    p_axes = params_axes(cfg)
    spec_tree = model_spec(cfg)

    def v_axes(spec):
        axes = spec.axes
        if ocfg.factored_v and _can_factor(spec.shape):
            return {"row": axes[:-1], "col": axes[:-2] + axes[-1:]}
        if ocfg.factored_v:
            return {"full": axes}
        return axes

    opt = {
        "m": p_axes,
        "v": map_specs(v_axes, spec_tree),
        "count": None,
    }
    if ocfg.master_dtype != "none":
        opt["master"] = p_axes
    return TrainState(params=p_axes, opt=opt, step=None)


def cache_axes(cache_shapes_tree: Any) -> Any:
    """Decode caches: dim0 is batch everywhere except stacked period caches,
    where dim0 is layers and dim1 is batch. We mark every dim None here and
    shard caches with an explicit batch rule in launch/specs.py instead."""
    return tree_map(lambda s: tuple([None] * len(s.shape)),
                    cache_shapes_tree)
