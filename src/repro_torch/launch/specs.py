"""Per-cell input specs: for every (architecture x shape) cell, the step,
its abstract arguments, their placements and donation. Port of
``repro/launch/specs.py``.

Abstract arguments are ``meta`` tensors (shapes and dtypes, no storage) in
place of ``ShapeDtypeStruct``; placements are the port's
:class:`repro_torch.sharding.PartitionSpec` trees in place of
``NamedSharding``. Nothing here needs a world: a ``DistContext`` over an
axis name -> size map (:func:`repro_torch.launch.mesh.mesh_axes`) gives
every spec, and the step builders make their closures without reading the
mesh. Running a cell's step needs a world of that mesh (or, for the costing
variant, none: see :func:`make_cell`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding.context import DistContext
from repro_torch.sharding.rules import P, axis_size, batch_spec


@dataclass
class CellSpec:
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple[int, ...] = ()
    static_notes: dict = field(default_factory=dict)


def optimizer_analytic_costs(cfg: ModelConfig, ocfg: OptimizerConfig,
                             accum_dtype: str, n_devices: int) -> dict:
    """Per-device FLOPs/bytes of the AdamW apply (pure elementwise over
    sharded state — no collectives). Counted analytically because the
    costing compiles cover only the fwd/bwd microbatch."""
    n = cfg.param_count(active_only=False)
    p_b = torch_dtype(cfg.dtype).itemsize
    m_b = torch_dtype(ocfg.moment_dtype).itemsize
    g_b = torch_dtype(accum_dtype).itemsize
    v_b = 0.01 * m_b if ocfg.factored_v else m_b
    mst_b = (0 if ocfg.master_dtype == "none"
             else torch_dtype(ocfg.master_dtype).itemsize)
    per_param_bytes = (g_b            # read grads
                       + 2 * p_b      # read + write params
                       + 2 * m_b      # read + write m
                       + 2 * v_b      # read + write v
                       + 2 * mst_b)   # read + write master
    return {
        "flops_per_device": 12.0 * n / n_devices,
        "bytes_per_device": per_param_bytes * n / n_devices,
        "collective_bytes": 0.0,
    }


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    """Memory policy per scale: the 671B config uses bf16 moments +
    factored second moment and no separate master copy — plain fp32 Adam
    does not fit 256×16 GB."""
    if cfg.name.startswith("deepseek"):
        return OptimizerConfig(moment_dtype="bfloat16", factored_v=True,
                               master_dtype="none")
    return OptimizerConfig()


def train_knobs(cfg: ModelConfig) -> dict:
    """remat / microbatch / accum dtype per arch for the train_4k cell.

    µ is sized so the per-microbatch fp32 logits working set stays within
    device memory: large-vocab/small-d archs (Gemma-3, InternVL) need
    µ=16."""
    if cfg.name.startswith("deepseek"):
        return {"remat": "full", "microbatch": 16, "accum_dtype": "bfloat16"}
    if cfg.name.startswith(("moonshot",)):
        return {"remat": "full", "microbatch": 8, "accum_dtype": "float32"}
    if cfg.padded_vocab >= 128_000 and cfg.d_model <= 4096:
        return {"remat": "full", "microbatch": 16, "accum_dtype": "float32"}
    return {"remat": "full", "microbatch": 4, "accum_dtype": "float32"}


def resolve_knobs(cfg: ModelConfig, dist: DistContext, global_batch: int,
                  overrides: dict | None = None) -> dict:
    """Clamp µ so each microbatch still shards over *all* batch axes —
    µ=16 on a 2×16×16 mesh would leave microbatches of 16 shardable over
    the pod axis only (16× per-device activation blowup)."""
    knobs = dict(train_knobs(cfg), **(overrides or {}))
    n_shards = axis_size(dist.mesh, dist.batch_axes)
    mu_max = max(1, global_batch // n_shards)
    mu = min(int(knobs.get("microbatch") or 1), mu_max)
    while mu > 1 and (global_batch // mu) % n_shards != 0:
        mu -= 1
    knobs["microbatch"] = mu
    return knobs


# ---------------------------------------------------------------------------
# batch construction
# ---------------------------------------------------------------------------

def _i32(shape):  # tokens / labels
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f32(shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def batch_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    """Abstract training/prefill batch for one global step."""
    if cfg.frontend is not None and cfg.frontend.kind == "audio_frames":
        return {"embeds": _f32((b, s, cfg.frontend.input_dim)),
                "labels": _i32((b, s))}
    if cfg.frontend is not None and cfg.frontend.kind == "vit_patches":
        n_p = cfg.frontend.n_positions
        s_txt = max(s - n_p, 8)
        return {"embeds": _f32((b, n_p, cfg.frontend.input_dim)),
                "tokens": _i32((b, s_txt)),
                "labels": _i32((b, s_txt))}
    return {"tokens": _i32((b, s)), "labels": _i32((b, s))}


def batch_shardings(dist: DistContext, batch: dict, b: int) -> dict:
    """The PartitionSpec of every entry of ``batch``."""
    return {k: dist.batch_pspec(v.dim(), b) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# cache shardings
# ---------------------------------------------------------------------------

def cache_sharding_tree(dist: DistContext, cfg: ModelConfig, shapes: Any,
                        batch: int) -> Any:
    """The PartitionSpec of every cache leaf: batch over the batch axes
    (dim 1 under the stacked ``periods``, dim 0 under ``tail``); the KV
    heads over ``model`` where it divides them, otherwise the cache's
    *sequence* dim (where it divides that); MLA's latent cache's sequence
    over ``model``. Recurrent states (SSD, RG-LRU) shard on the batch only.
    A paged pool (``pool_k``/``pool_v``) stays replicated."""
    tp = dist.tp_axis

    def one(keys: tuple, t) -> Any:
        bdim = 1 if "periods" in keys else 0
        shape = tuple(t.shape)
        spec: list = [None] * len(shape)
        if keys[-1] in ("pool_k", "pool_v"):
            return P(*spec)
        spec[bdim] = batch_spec(1, dist.batch_axes, shape[bdim],
                                dist.mesh)[0]
        is_kv = len(shape) >= 4 and keys[-1] in ("k", "v")
        is_mla = keys[-1] in ("c_kv", "k_rope") and len(shape) >= 3
        if is_kv and cfg.n_kv_heads and shape[-2] == cfg.n_kv_heads:
            if cfg.n_kv_heads % dist.tp_size == 0:
                spec[-2] = tp
            elif shape[-3] % dist.tp_size == 0:      # the sequence dim
                spec[-3] = tp
        elif is_mla and shape[bdim + 1] % dist.tp_size == 0:
            spec[bdim + 1] = tp      # MLA latent cache: sequence over model
        return P(*spec)

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (k,)) for k, v in tree.items()}
        return one(keys, tree)

    return walk(shapes, ())


def decode_cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Any:
    """The decode cache tree as ``meta`` tensors in the config's dtype."""
    from repro_torch.models.transformer import cache_shapes
    return cache_shapes(cfg, batch, max_len, torch_dtype(cfg.dtype))


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def reduced_depth(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    """Same arch at ``n_periods`` periods (remainder layers preserved): the
    dry-run's costing depths, between which its counts extrapolate
    linearly to full depth."""
    return cfg.with_(n_layers=cfg.period * n_periods + cfg.n_remainder)


def _params(cfg: ModelConfig, dist: DistContext) -> tuple[Any, Any]:
    from repro_torch.models.params import param_shapes
    from repro_torch.models.transformer import model_spec
    from repro_torch.sharding.state import params_axes
    shapes = param_shapes(model_spec(cfg), torch_dtype(cfg.dtype))
    return shapes, dist.param_shardings(shapes, params_axes(cfg))


def _costing_train(cfg: ModelConfig, knobs: dict) -> Callable:
    """The unsharded forward and backward of one microbatch:
    fb(params, batch) -> (loss, grads)."""
    from repro_torch.train.step import _loss_fn
    from repro_torch.tree import leaves, unflatten_as
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0

    def fb(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, _ = _loss_fn(unflatten_as(params, flat), cfg, batch, aux_w,
                               None, knobs["remat"])
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten_as(params, list(grads))

    return fb


def make_cell(arch: str, shape, dist: DistContext, *,
              costing_periods: int | None = None) -> CellSpec:
    """One cell: the deliverable step of ``shape.step`` with ``dist``, its
    arguments as ``meta`` tensors (the decode step's ``cache_index`` as a
    () int32 one), the placements of its arguments and outputs (``None``:
    whole on every rank), donation and notes, as the reference's.

    ``costing_periods``: the costing variant at that many periods
    (:func:`reduced_depth`), for counting operations without a world: its
    ``fn`` is the **unsharded** program (``dist=None``) at the cell's global
    shapes, to run on ``meta`` tensors, and a train cell's is the forward
    and backward of ONE microbatch (the dry-run multiplies by the
    microbatch count and adds the optimizer analytically, as the
    reference does). Its decode ``cache_index`` is the int 0. The
    placements are the deliverable's."""
    from repro_torch import configs
    from repro_torch.sharding.state import state_axes
    from repro_torch.train.step import (make_prefill_step, make_serve_step,
                                        make_train_step, train_state_shapes)
    cfg = configs.get_config(arch)
    b, s = shape.global_batch, shape.seq_len
    costing = costing_periods is not None
    if costing:
        cfg = reduced_depth(cfg, costing_periods)

    if shape.step == "train":
        ocfg = optimizer_for(cfg)
        knobs = resolve_knobs(cfg, dist, b)
        if costing:
            mb = max(1, knobs.get("microbatch") or 1)
            b_mb = max(b // mb, 1)
            batch = batch_specs(cfg, b_mb, s)
            p_shapes, p_sh = _params(cfg, dist)
            return CellSpec(fn=_costing_train(cfg, knobs),
                            args=(p_shapes, batch),
                            in_shardings=(p_sh, batch_shardings(dist, batch,
                                                                b_mb)),
                            out_shardings=None,
                            static_notes={"step": "train-fb",
                                          "microbatch": mb})
        state_shapes = train_state_shapes(cfg, ocfg)
        state_sh = dist.param_shardings(state_shapes, state_axes(cfg, ocfg))
        batch = batch_specs(cfg, b, s)
        fn = make_train_step(cfg, ocfg, dist=dist, **knobs)
        return CellSpec(fn=fn, args=(state_shapes, batch),
                        in_shardings=(state_sh, batch_shardings(dist, batch,
                                                                b)),
                        out_shardings=(state_sh, None), donate_argnums=(0,),
                        static_notes={"knobs": knobs, "step": "train"})

    # inference cells share abstract params (no optimizer)
    p_shapes, p_sh = _params(cfg, dist)
    step_dist = None if costing else dist
    if shape.step == "prefill":
        batch = batch_specs(cfg, b, s)
        batch_sh = batch_shardings(dist, batch, b)
        fn = make_prefill_step(cfg, dist=step_dist)
        if cfg.encoder_only:
            return CellSpec(fn=fn, args=(p_shapes, batch),
                            in_shardings=(p_sh, batch_sh), out_shardings=None,
                            static_notes={"step": "prefill"})
        batch.pop("labels", None)
        batch_sh.pop("labels", None)
        caches = decode_cache_shapes(cfg, b, s)
        caches_sh = cache_sharding_tree(dist, cfg, caches, b)
        return CellSpec(fn=fn, args=(p_shapes, batch, caches),
                        in_shardings=(p_sh, batch_sh, caches_sh),
                        out_shardings=(None, caches_sh),
                        donate_argnums=() if costing else (2,),
                        static_notes={"step": "prefill"})

    # decode: one new token against a seq_len cache
    caches = decode_cache_shapes(cfg, b, s)
    caches_sh = cache_sharding_tree(dist, cfg, caches, b)
    tokens = _i32((b, 1))
    idx = 0 if costing else torch.empty((), dtype=torch.int32, device="meta")
    fn = make_serve_step(cfg, dist=step_dist)
    return CellSpec(fn=fn, args=(p_shapes, tokens, caches, idx),
                    in_shardings=(p_sh, dist.batch_pspec(2, b), caches_sh,
                                  P()),
                    out_shardings=(None, None, caches_sh),
                    donate_argnums=() if costing else (2,),
                    static_notes={"step": "decode"})
