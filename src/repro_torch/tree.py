"""Nested containers of tensors, walked the way JAX walks a pytree.

The port keeps the reference's functional shape — parameters and optimizer
state are nested dicts of tensors — so it needs the few tree operations
the reference takes from ``jax.tree_util``, in the same order: dict keys
sorted, lists and tuples by index, ``None`` an empty node, and registered
classes (``TrainState``) by their children. :func:`paths` names each leaf
as ``jax.tree_util.keystr`` does (``['embed']['embedding']``, ``[0]``, and
``[<flat index i>]`` under a registered class), which is what the
checkpoint manifest records.
"""
from __future__ import annotations

from typing import Any, Callable

_NODES: dict[type, tuple[Callable, Callable]] = {}


def register_node(cls: type, children: Callable[[Any], tuple],
                  rebuild: Callable[[tuple], Any]) -> None:
    """Walk instances of ``cls`` by ``children(obj)``; ``rebuild(values)``
    makes one back."""
    _NODES[cls] = (children, rebuild)


def _node(tree: Any):
    """(keys, children, rebuild) of a container, or None for a leaf."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ([f"[{k!r}]" for k in keys], [tree[k] for k in keys],
                lambda vals: dict(zip(keys, vals)))
    if isinstance(tree, (list, tuple)):
        kind = type(tree)
        return ([f"[{i}]" for i in range(len(tree))], list(tree),
                lambda vals: kind(vals))
    if tree is None:
        return [], [], lambda vals: None
    spec = _NODES.get(type(tree))
    if spec is not None:
        children = list(spec[0](tree))
        return ([f"[<flat index {i}>]" for i in range(len(children))],
                children, lambda vals: spec[1](tuple(vals)))
    return None


def paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) of every leaf, in flattening order."""
    node = _node(tree)
    if node is None:
        return [(prefix, tree)]
    out: list = []
    for key, child in zip(node[0], node[1]):
        out.extend(paths(child, prefix + key))
    return out


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (as ``jax.tree.map``)."""
    node = _node(tree)
    if node is None:
        return fn(tree, *rest)
    others = [_node(r)[1] for r in rest]
    return node[2]([tree_map(fn, c, *(o[i] for o in others))
                    for i, c in enumerate(node[1])])


def flatten_up_to(structure: Any, tree: Any) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure``."""
    node = _node(structure)
    if node is None:
        return [tree]
    out: list = []
    for s, t in zip(node[1], _node(tree)[1]):
        out.extend(flatten_up_to(s, t))
    return out


def unflatten_as(structure: Any, values: list) -> Any:
    """A tree shaped like ``structure`` with ``values`` at its leaves."""
    it = iter(values)
    return tree_map(lambda _: next(it), structure)
