"""Parameter-tree machinery: shapes and logical axes, declared once.

Port of ``repro/models/params.py``. Every parameter is a :class:`ParamSpec`
(shape, logical axes, init) in a nested dict; from the spec tree come

* ``init_params(specs, generator, dtype, device)`` — tensors drawn with an
  explicit ``torch.Generator`` on the target device, in the target dtype
  (a full-width bf16 model is never built in float32 on the host first);
* ``param_shapes(specs, dtype)`` — ``meta`` tensors: shape and dtype with
  no storage, the counterpart of the reference's ``ShapeDtypeStruct`` tree;
* ``logical_axes(specs)`` and ``count_params(specs)``.

The random numbers are torch's, not JAX's: the same seed gives other
weights. Parity tests carry a JAX tree across with
:func:`repro_torch.convert.tree_to_torch` instead.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"        # normal | zeros | ones | lecun | lambda_rglru | dt_bias | a_log
    scale: float | None = None  # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def map_specs(fn: Callable[[ParamSpec], Any], tree: Any) -> Any:
    """``fn`` on every spec of a nested dict, same nesting."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a spec tree: {type(tree)}")


def spec_leaves(tree: Any) -> list[ParamSpec]:
    out: list[ParamSpec] = []
    map_specs(out.append, tree)
    return out


def _fan_in(shape: tuple[int, ...]) -> int:
    # convention: last axis is the output axis for 2D+ weights
    if len(shape) == 1:
        return shape[0]
    return int(np.prod(shape[:-1]))


def _uniform(spec: ParamSpec, gen: torch.Generator, device, lo: float,
             hi: float) -> torch.Tensor:
    u = torch.rand(spec.shape, generator=gen, device=device,
                   dtype=torch.float32)
    return u * (hi - lo) + lo


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "lecun"):
        if spec.init == "normal":
            std = spec.scale if spec.scale is not None else 0.02
        else:
            std = 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
        x = torch.randn(spec.shape, generator=gen, device=device, dtype=dtype)
        return x.mul_(std)
    # the small recurrent-layer vectors: drawn in float32, then cast
    if spec.init == "lambda_rglru":
        u = _uniform(spec, gen, device, 0.9, 0.999)
        return torch.log(torch.expm1(-torch.log(u) / 8.0)).to(dtype)
    if spec.init == "dt_bias":
        u = _uniform(spec, gen, device, 1e-3, 1e-1)
        return torch.log(torch.expm1(u)).to(dtype)
    if spec.init == "a_log":
        return torch.log(_uniform(spec, gen, device, 1.0, 16.0)).to(dtype)
    raise ValueError(f"unknown init {spec.init}")


def init_params(specs: Any, generator: torch.Generator, dtype: torch.dtype,
                device: str | torch.device = "cuda") -> Any:
    """Materialize the spec tree: each leaf drawn from ``generator`` (which
    must live on ``device``) directly in ``dtype`` on ``device``."""
    from repro_torch.convert import resolve_device
    dev = resolve_device(device)
    return map_specs(lambda s: _init_leaf(s, generator, dtype, dev), specs)


def param_shapes(specs: Any, dtype: torch.dtype) -> Any:
    return map_specs(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def logical_axes(specs: Any) -> Any:
    return map_specs(lambda s: s.axes, specs)


def count_params(specs: Any) -> int:
    return sum(int(np.prod(s.shape)) for s in spec_leaves(specs))


def stack_specs(spec_tree: Any, n: int) -> Any:
    """Prepend a ``layers`` axis of length ``n`` to every spec — the layout
    of a repeated layer period, one slice per period."""
    return map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                            init=s.init, scale=s.scale),
        spec_tree)
