"""AdamW with the memory policies of the reference. Port of
``repro/optim/adamw.py``:

* ``moment_dtype`` — first/second moments kept in this dtype (bf16 halves
  them),
* ``factored_v`` — Adafactor-style factored second moment (row/col means
  over the trailing two axes),
* ``master_dtype`` — fp32 master copy when model params are bf16;
  ``"none"`` keeps a single copy in ``params``.

Functions over nested dicts of tensors, as in the reference: each call
returns new trees and leaves its inputs as they were. They run under
``torch.no_grad()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.layers import torch_dtype
from repro_torch.tree import flatten_up_to, leaves, tree_map, unflatten_as


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    factored_v: bool = False
    master_dtype: str = "float32"   # "none" => params are the master copy
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"


def _can_factor(shape: tuple[int, ...]) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


@torch.no_grad()
def adamw_init(params: Any, cfg: OptimizerConfig) -> dict:
    mdt = torch_dtype(cfg.moment_dtype)
    m = tree_map(lambda p: _zeros(p.shape, mdt, p), params)
    if cfg.factored_v:
        def make_v(p):
            if _can_factor(tuple(p.shape)):
                return {"row": _zeros(p.shape[:-1], mdt, p),
                        "col": _zeros(p.shape[:-2] + p.shape[-1:], mdt, p)}
            return {"full": _zeros(p.shape, mdt, p)}
        v = tree_map(make_v, params)
    else:
        v = tree_map(lambda p: _zeros(p.shape, mdt, p), params)
    flat = leaves(params)
    state = {"m": m, "v": v,
             "count": torch.zeros((), dtype=torch.int32,
                                  device=flat[0].device if flat else None)}
    if cfg.master_dtype != "none":
        mast = torch_dtype(cfg.master_dtype)
        state["master"] = tree_map(lambda p: p.to(mast, copy=True), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    total = None
    for x in leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _v_update_and_corr(v_leaf, g2, b2, cfg):
    """Update (possibly factored) second moment; return (new_v, denom f32)."""
    mdt = torch_dtype(cfg.moment_dtype)
    if isinstance(v_leaf, dict) and "row" in v_leaf:
        row = v_leaf["row"].float() * b2 + g2.mean(dim=-1) * (1 - b2)
        col = v_leaf["col"].float() * b2 + g2.mean(dim=-2) * (1 - b2)
        # rank-1 reconstruction (adafactor): v ≈ row ⊗ col / mean(row)
        denom = row[..., None] * col[..., None, :] / torch.clamp_min(
            row.mean(dim=-1, keepdim=True)[..., None], 1e-30)
        return {"row": row.to(mdt), "col": col.to(mdt)}, denom
    if isinstance(v_leaf, dict):
        full = v_leaf["full"].float() * b2 + g2 * (1 - b2)
        return {"full": full.to(mdt)}, full
    full = v_leaf.float() * b2 + g2 * (1 - b2)
    return full.to(mdt), full


def update_leaf(p, g, m, v, w, *, scale, bc1, bc2, lr,
                cfg: OptimizerConfig):
    """One parameter's AdamW step: (new param, new m, new v, new master)
    from the param, its gradient, its moments and its master copy ``w``
    (the param itself when ``master_dtype`` is ``"none"``)."""
    mdt = torch_dtype(cfg.moment_dtype)
    gf = g.float() * scale
    mf = m.float() * cfg.b1 + gf * (1 - cfg.b1)
    vv, denom = _v_update_and_corr(v, gf.square(), cfg.b2, cfg)
    upd = (mf / bc1) / (torch.sqrt(denom / bc2) + cfg.eps)
    wf = w.float()
    if cfg.weight_decay > 0 and p.dim() >= 2:
        upd = upd + cfg.weight_decay * wf
    wf = wf - lr * upd
    master = wf.to(torch_dtype(cfg.master_dtype)) \
        if cfg.master_dtype != "none" else wf.to(p.dtype)
    return wf.to(p.dtype), mf.to(mdt), vv, master


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: OptimizerConfig,
                 lr: torch.Tensor, *, grad_norm: torch.Tensor | None = None,
                 leaf_fn=update_leaf) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_state, stats). ``grad_norm``: the global
    gradient norm when the caller has it (a sharded step sums its shards
    across ranks); ``leaf_fn``: :func:`update_leaf` or a caller's wrapper
    of it (the sharded step's runs it on each rank's shards)."""
    count = state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    if cfg.grad_clip > 0:
        scale = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                                1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)

    bc1 = 1.0 - cfg.b1 ** count.float()
    bc2 = 1.0 - cfg.b2 ** count.float()
    masters = state.get("master", params)

    flat_p = leaves(params)
    flat_g = flatten_up_to(params, grads)
    flat_m = flatten_up_to(params, state["m"])
    flat_v = flatten_up_to(params, state["v"])
    flat_master = flatten_up_to(params, masters)

    new_p, new_m, new_v, new_master = [], [], [], []
    for p, g, m, v, w in zip(flat_p, flat_g, flat_m, flat_v, flat_master):
        p2, m2, v2, w2 = leaf_fn(p, g, m, v, w, scale=scale, bc1=bc1,
                                 bc2=bc2, lr=lr, cfg=cfg)
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
        new_master.append(w2)

    state2 = {"m": unflatten_as(params, new_m),
              "v": unflatten_as(params, new_v),
              "count": count}
    if cfg.master_dtype != "none":
        state2["master"] = unflatten_as(params, new_master)
    stats = {"grad_norm": gnorm, "lr": lr}
    return unflatten_as(params, new_p), state2, stats
