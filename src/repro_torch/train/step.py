"""Step builders: train, prefill and serve. Port of
``repro/train/step.py``.

The reference wraps these steps in ``jax.jit``; PyTorch runs them eagerly.
A decode step writes the caches in place and returns the same tree. The
train step takes its gradients with ``torch.autograd.grad`` and returns a
new :class:`TrainState`, leaving the one it was given as it was.

Not accepted yet, each raising ``NotImplementedError`` with its ROADMAP
item: ``dist`` (Queue 1, item 8) and any ``remat`` but ``"none"``
(activation checkpointing, Queue 1, item 8 with the sharded paths).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import init_params, param_shapes
from repro_torch.models.transformer import forward, init_caches, model_spec
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               lr_at_step)
from repro_torch.tree import leaves, register_node, tree_map, unflatten_as

from .loss import lm_loss

_SHARDED = "sharded execution (dist) comes with the sharded slice: " \
           "ROADMAP.md Queue 1, item 8"
_REMAT = "activation checkpointing (remat) comes with the sharded slice: " \
         "ROADMAP.md Queue 1, item 8"


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


def _loss_fn(params, cfg: ModelConfig, batch: dict, aux_weight: float):
    logits, _, aux = forward(params, cfg, batch)
    loss, metrics = lm_loss(logits, batch["labels"], batch.get("weights"))
    loss = loss + aux_weight * aux.to(loss.device)
    metrics["aux_loss"] = aux
    return loss, metrics


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig, *,
                    dist: Any = None, remat: str = "none",
                    microbatch: int | None = None,
                    accum_dtype: str = "float32") -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch``: {"tokens", "labels"[, "weights"]} tensors on the state's
    device. ``microbatch``: split the batch into this many sequential
    chunks with gradient accumulation in ``accum_dtype``."""
    if dist is not None:
        raise NotImplementedError(_SHARDED)
    if remat != "none":
        raise NotImplementedError(_REMAT)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    adt = torch_dtype(accum_dtype)

    def grad_fn(params, batch):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss, metrics = _loss_fn(unflatten_as(params, flat), cfg, batch,
                                     aux_w)
            # a leaf the loss does not reach (hubert's token embedding: its
            # frames bypass it) gets zeros, as jax.grad gives
            grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten_as(params, list(grads))

    def compute_grads(params, batch):
        if not microbatch or microbatch <= 1:
            return grad_fn(params, batch)
        parts = {k: torch.chunk(v, microbatch, dim=0)
                 for k, v in batch.items()}
        gacc, loss_sum, metrics = None, 0.0, None
        for i in range(microbatch):
            loss, metrics, g = grad_fn(params, {k: v[i]
                                                for k, v in parts.items()})
            g = tree_map(lambda x: x.to(adt), g)
            gacc = g if gacc is None else tree_map(torch.add, gacc, g)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda g: g / microbatch, gacc)
        return loss_sum / microbatch, metrics, grads

    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = compute_grads(state.params, batch)
        lr = lr_at_step(state.step, base_lr=ocfg.lr,
                        warmup_steps=ocfg.warmup_steps,
                        total_steps=ocfg.total_steps, schedule=ocfg.schedule)
        params, opt, stats = adamw_update(state.params, grads, state.opt,
                                          ocfg, lr)
        metrics = dict(metrics, loss=loss, **stats)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """prefill(params, batch, caches) -> (last-token logits, caches).
    Encoder-only models take no caches and return per-frame logits."""
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


def make_serve_step(cfg: ModelConfig, *, paged: bool = False,
                    decode_kernel: str | None = None) -> Callable:
    """serve_step(params, tokens (B,1), caches, cache_index[, pages]) ->
    (next-token logits (B, V), greedy next ids (B,) int32, caches). One
    decode step against the cache.

    ``decode_kernel`` overrides ``cfg.decode_kernel`` ("chunked" reference |
    "flash" kernels). ``paged=True`` gives the paged-cache step, which takes
    the (B, pages_per_slot) page table as a fifth argument (caches from
    ``init_paged_caches``)."""
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
