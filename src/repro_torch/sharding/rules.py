"""Logical-axis → mesh-axis resolution with divisibility fallback.

Port of ``repro/sharding/rules.py``. Parameters and activations carry
*logical* axis names (see :mod:`repro_torch.models.params`). This module
maps them onto the physical mesh:

* the ``model`` axis carries tensor/expert parallelism — the first logical
  axis present in ``_MODEL_CANDIDATES`` priority order that is divisible by
  the axis size wins;
* the FSDP axes (``('pod', 'data')`` multi-pod, ``('data',)`` single-pod)
  shard the largest remaining dim (ZeRO-3: parameters, gradients and
  optimizer state all inherit this);
* anything indivisible falls back to replicated for that dim (MaxText-style)
  — e.g. gemma3-1b's 4 q-heads on a 16-way model axis.

The functions are pure: a mesh is anything that gives an ordered axis name →
size mapping (:func:`mesh_shape`): a ``torch.distributed.DeviceMesh`` with
``mesh_dim_names``, a plain dict, or :func:`repro_torch.launch.mesh.mesh_axes`.
The reference's ``PartitionSpec`` is JAX's; the port's :class:`PartitionSpec`
is a tuple of ``None | str | tuple[str, ...]`` per dim, and
:func:`to_placements` turns one into DTensor placements.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Sequence

from repro_torch.tree import flatten_up_to, leaves, unflatten_as

_MODEL_CANDIDATES = ("experts", "heads", "kv_heads", "vocab", "ff",
                     "expert_ff", "lora")
_FSDP_CANDIDATES = ("embed", "lora", "ff", "expert_ff", "head_dim", "vocab")


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim sharded over those axes, major first)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh: Any) -> dict[str, int]:
    """The ordered axis name → size mapping of ``mesh``."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:          # torch.distributed.DeviceMesh
        return {n: int(s) for n, s in zip(names, mesh.shape)}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    raise TypeError(f"not a mesh: {type(mesh).__name__}")


def axis_size(mesh: Any, names: Sequence[str] | str | None) -> int:
    """The product of the sizes of ``names`` (1 for None or ())."""
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    n = 1
    for a in names:
        n *= shape[a]
    return n


def resolve_spec(axes: tuple[str | None, ...], shape: tuple[int, ...],
                 mesh: Any, *, fsdp_axes: tuple[str, ...],
                 tp_axis: str = "model") -> PartitionSpec:
    """One tensor: logical axes + shape -> PartitionSpec."""
    assignment: list[Any] = [None] * len(axes)
    used_dims: set[int] = set()
    tp_size = mesh_shape(mesh)[tp_axis]
    # 1. model axis
    for cand in _MODEL_CANDIDATES:
        hit = False
        for i, a in enumerate(axes):
            if a == cand and shape[i] % tp_size == 0 and shape[i] > 0:
                assignment[i] = tp_axis
                used_dims.add(i)
                hit = True
                break
        if hit:
            break
    # 2. fsdp axes
    fsdp_size = axis_size(mesh, fsdp_axes)
    for cand in _FSDP_CANDIDATES:
        hit = False
        for i, a in enumerate(axes):
            if i in used_dims:
                continue
            if a == cand and shape[i] % fsdp_size == 0 and shape[i] > 0:
                assignment[i] = fsdp_axes if len(fsdp_axes) > 1 \
                    else fsdp_axes[0]
                used_dims.add(i)
                hit = True
                break
        if hit:
            break
    return P(*assignment)


def tree_shardings(shapes_tree: Any, axes_tree: Any, mesh: Any, *,
                   fsdp_axes: tuple[str, ...], tp_axis: str = "model") -> Any:
    """Map a tree of shaped leaves (tensors, ``meta`` tensors) + a matching
    tree of logical-axis tuples (axes tuples are *leaves* of the axes tree)
    to PartitionSpecs; a ``None`` axes entry gives the replicated ``P()``."""
    leaves_s = leaves(shapes_tree)
    leaves_a = flatten_up_to(shapes_tree, axes_tree)

    def one(t, axes):
        if axes is None:
            return P()
        return resolve_spec(tuple(axes), tuple(t.shape), mesh,
                            fsdp_axes=fsdp_axes, tp_axis=tp_axis)

    return unflatten_as(shapes_tree,
                        [one(s, a) for s, a in zip(leaves_s, leaves_a)])


def batch_spec(ndim: int, batch_axes: tuple[str, ...], batch_size: int,
               mesh: Any) -> PartitionSpec:
    """Shard dim 0 (batch) over the data axes, with divisibility fallback."""
    size = axis_size(mesh, batch_axes)
    if batch_size % size == 0:
        first = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        return P(first, *([None] * (ndim - 1)))
    # try pod-only / data-only prefixes before giving up
    for sub in (batch_axes[:1], batch_axes[1:]):
        if sub and batch_size % axis_size(mesh, sub) == 0:
            return P(sub if len(sub) > 1 else sub[0], *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def entry_axes(entry: Any) -> tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, (name,) for a name."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def to_placements(spec: Sequence, axis_names: Sequence[str]) -> tuple:
    """DTensor placements (one per mesh dim, in ``axis_names`` order) of a
    spec: ``Shard(i)`` on every mesh dim named in ``spec[i]``,
    ``Replicate()`` elsewhere. A dim over ``('pod', 'data')`` is split over
    ``pod`` first, then ``data`` within it, as the mesh orders them (JAX's
    order for a tuple entry, which names the axes major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    out: list = [Replicate() for _ in axis_names]
    order = list(axis_names)
    for i, entry in enumerate(spec):
        names = entry_axes(entry)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {tuple(axis_names)}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)
