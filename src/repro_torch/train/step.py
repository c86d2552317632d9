"""Step builders: train, prefill and serve. Port of
``repro/train/step.py``.

The reference wraps these steps in ``jax.jit``; PyTorch runs them eagerly.
A decode step writes the caches in place and returns the same tree. The
train step takes its gradients with ``torch.autograd.grad`` and returns a
new :class:`TrainState`, leaving the one it was given as it was.

``dist=None`` gives the single-device path; with a
:class:`repro_torch.sharding.DistContext` the train step runs sharded (its
state from :func:`shard_train_state`, its batch from
``DistContext.shard_batch``): the vocab-parallel loss, the MoE
expert-parallel island, activation constraints, and AdamW on each rank's
shards. ``remat`` checkpoints each period of the stack
(:func:`repro_torch.models.transformer.period_runner`). ``dist`` in the
prefill and serve steps (their cache shardings) comes with the last sharded
slice (ROADMAP.md Queue 1, item 8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import init_params, param_shapes
from repro_torch.models.transformer import (forward, init_caches, model_spec,
                                            period_runner)
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               lr_at_step)
from repro_torch.tree import leaves, register_node, tree_map, unflatten_as

from .loss import lm_loss

_SHARDED_SERVE = "sharded prefill and serve steps (dist; their cache " \
                 "shardings) come with the last sharded slice: ROADMAP.md " \
                 "Queue 1, item 8"


@dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor      # int32 scalar on the params' device


register_node(TrainState, lambda s: (s.params, s.opt, s.step),
              lambda ch: TrainState(*ch))


def init_train_state(cfg: ModelConfig, ocfg: OptimizerConfig,
                     generator: torch.Generator,
                     device: str | torch.device = "cuda") -> TrainState:
    """Params drawn from ``generator`` (which must live on ``device``) in
    the config's dtype, the optimizer state, step 0."""
    from repro_torch.convert import resolve_device
    dev = resolve_device(device)
    params = init_params(model_spec(cfg), generator, torch_dtype(cfg.dtype),
                         dev)
    return TrainState(params=params, opt=adamw_init(params, ocfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def train_state_shapes(cfg: ModelConfig, ocfg: OptimizerConfig) -> TrainState:
    """The TrainState as ``meta`` tensors: shapes and dtypes, no storage."""
    params = param_shapes(model_spec(cfg), torch_dtype(cfg.dtype))
    return TrainState(params=params, opt=adamw_init(params, ocfg),
                      step=torch.zeros((), dtype=torch.int32, device="meta"))


def shard_train_state(state: TrainState, cfg: ModelConfig,
                      ocfg: OptimizerConfig, dist: Any) -> TrainState:
    """``state`` (the same on every rank) with every leaf a DTensor placed
    by the sharding rules of :func:`repro_torch.sharding.state_axes`."""
    from repro_torch.sharding.state import state_axes
    specs = dist.param_shardings(train_state_shapes(cfg, ocfg),
                                 state_axes(cfg, ocfg))
    return dist.distribute(state, specs)


def _loss_fn(params, cfg: ModelConfig, batch: dict, aux_weight: float,
             dist: Any = None, remat: str = "none"):
    weights = batch.get("weights")
    logits, _, aux = forward(params, cfg, batch, dist=dist, remat=remat)
    if dist is not None:
        loss, metrics = dist.vocab_parallel_loss(logits, batch["labels"],
                                                 weights)
    else:
        loss, metrics = lm_loss(logits, batch["labels"], weights)
    loss = loss + aux_weight * aux.to(loss.device)
    metrics["aux_loss"] = aux
    return loss, metrics


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig, *,
                    dist: Any = None, remat: str = "none",
                    microbatch: int | None = None,
                    accum_dtype: str = "float32") -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens", "labels"[, "weights"]} tensors on the state's
    device (DTensors sharded by ``dist.shard_batch`` under ``dist``).
    ``microbatch``: split the batch into this many sequential chunks with
    gradient accumulation in ``accum_dtype``. ``remat``: "none" | "full" |
    "dots" | "dots_no_batch" (an unknown name raises ``KeyError``)."""
    period_runner(remat)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    adt = torch_dtype(accum_dtype)

    def grad_fn(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = _loss_fn(unflatten_as(params, flat), cfg, batch,
                                     aux_w, dist, remat)
            # every rank holds the loss; under dist each seeds its share
            # (DistContext.grad_seed) and the collectives' transposes sum
            seed = torch.full_like(loss, 1.0 if dist is None
                                   else dist.grad_seed)
            # a leaf the loss does not reach (hubert's token embedding: its
            # frames bypass it) gets zeros, as jax.grad gives
            grads = torch.autograd.grad(loss, flat, grad_outputs=seed,
                                        allow_unused=True,
                                        materialize_grads=True)
        if dist is not None:
            # a gradient that left its region partial where its param is
            # replicated (no redistribution on the way in) is summed here
            grads = [g if tuple(g.placements) == tuple(p.placements)
                     else g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, flat)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten_as(params, list(grads))

    def split(batch):
        """The microbatches: rows [i B/µ, (i+1) B/µ) of the global batch,
        each placed anew by ``dist`` (its own batch sharding)."""
        if dist is None:
            parts = {k: torch.chunk(v, microbatch, dim=0)
                     for k, v in batch.items()}
            return [{k: v[i] for k, v in parts.items()}
                    for i in range(microbatch)]
        parts = {k: torch.chunk(v.full_tensor(), microbatch, dim=0)
                 for k, v in batch.items()}
        return [dist.shard_batch({k: v[i] for k, v in parts.items()})
                for i in range(microbatch)]

    tmap = tree_map if dist is None else dist.map_local

    def compute_grads(params, batch):
        if not microbatch or microbatch <= 1:
            return grad_fn(params, batch)
        gacc, loss_sum, metrics = None, 0.0, None
        for part in split(batch):
            loss, metrics, g = grad_fn(params, part)
            g = tmap(lambda x: x.to(adt), g)
            gacc = g if gacc is None else tmap(torch.add, gacc, g)
            loss_sum = loss_sum + loss
        grads = tmap(lambda g: g / microbatch, gacc)
        return loss_sum / microbatch, metrics, grads

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = compute_grads(state.params, batch)
        step = state.step if dist is None else state.step.to_local()
        lr = lr_at_step(step, base_lr=ocfg.lr,
                        warmup_steps=ocfg.warmup_steps,
                        total_steps=ocfg.total_steps, schedule=ocfg.schedule)
        update = adamw_update if dist is None else dist.adamw_update
        params, opt, stats = update(state.params, grads, state.opt, ocfg, lr)
        metrics = dict(metrics, loss=loss, **stats)
        return TrainState(params, opt, tmap(lambda s: s + 1, state.step)), \
            metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, *, dist: Any = None) -> Callable:
    """prefill(params, batch, caches) -> (last-token logits, caches).
    Encoder-only models take no caches and return per-frame logits."""
    if dist is not None:
        raise NotImplementedError(_SHARDED_SERVE)
    if cfg.encoder_only:
        def prefill_enc(params, batch):
            logits, _, _ = forward(params, cfg, batch)
            return logits
        return prefill_enc

    @torch.no_grad()
    def prefill(params, batch, caches):
        dev = batch["tokens"].device
        logits, new_caches, _ = forward(
            params, cfg, batch, caches=caches,
            cache_index=torch.zeros((), dtype=torch.int32, device=dev))
        return logits[:, -1], new_caches

    return prefill


def make_serve_step(cfg: ModelConfig, *, dist: Any = None,
                    paged: bool = False,
                    decode_kernel: str | None = None) -> Callable:
    """serve_step(params, tokens (B,1), caches, cache_index[, pages]) ->
    (next-token logits (B, V), greedy next ids (B,) int32, caches). One
    decode step against the cache.

    ``decode_kernel`` overrides ``cfg.decode_kernel`` ("chunked" reference |
    "flash" kernels). ``paged=True`` gives the paged-cache step, which takes
    the (B, pages_per_slot) page table as a fifth argument (caches from
    ``init_paged_caches``)."""
    if dist is not None:
        raise NotImplementedError(_SHARDED_SERVE)
    if decode_kernel is not None:
        cfg = cfg.with_(decode_kernel=decode_kernel)

    def _finish(logits):
        logits = logits[:, -1]
        if cfg.padded_vocab != cfg.vocab_size:  # mask vocab padding
            pad_mask = torch.arange(cfg.padded_vocab,
                                    device=logits.device) >= cfg.vocab_size
            logits = torch.where(pad_mask[None, :],
                                 torch.tensor(-1e30, dtype=logits.dtype,
                                              device=logits.device), logits)
        next_id = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_id

    if paged:
        @torch.no_grad()
        def serve_step(params, tokens, caches, cache_index, pages):
            logits, new_caches, _ = forward(
                params, cfg, {"tokens": tokens}, caches=caches,
                cache_index=cache_index, pages=pages)
            logits, next_id = _finish(logits)
            return logits, next_id, new_caches
        return serve_step

    @torch.no_grad()
    def serve_step(params, tokens, caches, cache_index):
        logits, new_caches, _ = forward(params, cfg, {"tokens": tokens},
                                        caches=caches,
                                        cache_index=cache_index)
        logits, next_id = _finish(logits)
        return logits, next_id, new_caches

    return serve_step


def make_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device: str | torch.device = "cuda"):
    return init_caches(cfg, batch, max_len, torch_dtype(cfg.dtype), device)
