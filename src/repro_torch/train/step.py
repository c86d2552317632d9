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
shards; under ``chunked_ce`` (where ``model`` divides the vocabulary)
the loss is the fused, chunked ``DistContext.fused_ce`` on the hidden
states. ``remat`` checkpoints each period of the stack
(:func:`repro_torch.models.transformer.period_runner`). The prefill and
serve steps take ``dist`` too: params placed by the rules, caches by
:func:`repro_torch.launch.specs.cache_sharding_tree` (paged pools
replicated), tokens sharded over the batch axes (a plain tensor is placed
by ``DistContext.shard_batch``); they return the logits whole on every
rank, as the reference's unsharded outputs are.

The train step opens the profiler ranges ``repro.train_step`` and, inside
it, ``repro.forward``, ``repro.backward`` and ``repro.optimizer``; every
kernel the step launches falls in exactly one of the three. The encoder
call opens ``repro.encode`` (:func:`repro_torch.obs.trace.span`).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.autograd import Variable

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.params import init_params, param_shapes
from repro_torch.models.transformer import (forward, init_caches, model_spec,
                                            period_runner)
from repro_torch.obs.trace import span
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               lr_at_step)
from repro_torch.tree import leaves, register_node, tree_map, unflatten_as

from .loss import lm_loss


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
    fused = (dist is not None and dist.has("chunked_ce")
             and cfg.padded_vocab % dist.tp_size == 0)
    if fused:
        hidden, _, aux = forward(params, cfg, batch, dist=dist, remat=remat,
                                 return_hidden=True)
        loss, metrics = dist.fused_ce(hidden, params["embed"], cfg,
                                      batch["labels"], weights)
    else:
        logits, _, aux = forward(params, cfg, batch, dist=dist, remat=remat)
        if dist is not None:
            loss, metrics = dist.vocab_parallel_loss(logits, batch["labels"],
                                                     weights)
        else:
            loss, metrics = lm_loss(logits, batch["labels"], weights)
    loss = loss + aux_weight * aux.to(loss.device)
    metrics["aux_loss"] = aux
    return loss, metrics


class _BackwardSpan(torch.autograd.Function):
    """The identity on the loss, whose backward opens ``repro.backward`` on
    the thread that runs the backward where that is not the caller's: on
    CUDA the autograd engine runs the backward's nodes on its device thread,
    where a range opened by the caller would credit none of their kernels.
    The range closes when the engine has finished the graph, on the thread
    that ran its last node."""

    @staticmethod
    def forward(ctx, loss):
        ctx.owner = threading.get_ident()
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, g):
        if threading.get_ident() != ctx.owner:
            rng = span("repro.backward")
            rng.__enter__()
            Variable._execution_engine.queue_callback(
                lambda: rng.__exit__(None, None, None))
        return g


def _backward_root(loss):
    """``loss`` as the root of the backward: under a running profiler
    through :class:`_BackwardSpan`; else ``loss`` itself, nothing added to
    the graph."""
    if torch.autograd.profiler._is_profiler_enabled:
        return _BackwardSpan.apply(loss)
    return loss


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
        with span("repro.forward"), torch.enable_grad():
            flat = [p.detach().requires_grad_(True) for p in leaves(params)]
            loss, metrics = _loss_fn(unflatten_as(params, flat), cfg, batch,
                                     aux_w, dist, remat)
        with span("repro.backward"):
            # every rank holds the loss; under dist each seeds its share
            # (DistContext.grad_seed) and the collectives' transposes sum
            seed = torch.full_like(loss, 1.0 if dist is None
                                   else dist.grad_seed)
            # a leaf the loss does not reach (hubert's token embedding: its
            # frames bypass it) gets zeros, as jax.grad gives
            grads = torch.autograd.grad(_backward_root(loss), flat,
                                        grad_outputs=seed, allow_unused=True,
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
        with span("repro.forward"):     # placing the parts feeds the forward
            parts = split(batch)
        for part in parts:
            loss, metrics, g = grad_fn(params, part)
            with span("repro.backward"):    # the accumulation is backward's
                g = tmap(lambda x: x.to(adt), g)
                gacc = g if gacc is None else tmap(torch.add, gacc, g)
                loss_sum = loss_sum + loss
        with span("repro.backward"):
            grads = tmap(lambda g: g / microbatch, gacc)
            return loss_sum / microbatch, metrics, grads

    def train_step(state: TrainState, batch: dict):
        with span("repro.train_step"):
            loss, metrics, grads = compute_grads(state.params, batch)
            with span("repro.optimizer"):
                step = state.step if dist is None else state.step.to_local()
                lr = lr_at_step(step, base_lr=ocfg.lr,
                                warmup_steps=ocfg.warmup_steps,
                                total_steps=ocfg.total_steps,
                                schedule=ocfg.schedule)
                update = adamw_update if dist is None else dist.adamw_update
                params, opt, stats = update(state.params, grads, state.opt,
                                            ocfg, lr)
                new_step = tmap(lambda s: s + 1, state.step)
        return TrainState(params, opt, new_step), \
            dict(metrics, loss=loss, **stats)

    return train_step


def _placed(batch: dict, dist: Any) -> dict:
    """The batch's plain tensors sharded by ``dist`` (DTensors kept)."""
    if dist is None:
        return batch
    from repro_torch.sharding.context import is_dtensor
    plain = {k: v for k, v in batch.items()
             if v is not None and not is_dtensor(v)}
    return {**batch, **dist.shard_batch(plain)} if plain else batch


def _whole(logits, last: bool = False):
    """Logits (B, S, V) as a tensor on every rank (a DTensor gathered;
    ``last``: only the last position's (B, V), cut before the gather)."""
    from repro_torch.sharding.context import is_dtensor
    if not is_dtensor(logits):
        return logits[:, -1] if last else logits
    if last:
        from torch.distributed.tensor import DTensor, Shard
        pl = [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
              for p in logits.placements]
        logits = DTensor.from_local(logits.to_local()[:, -1],
                                    logits.device_mesh, pl, run_check=False)
    return logits.full_tensor()


def make_prefill_step(cfg: ModelConfig, *, dist: Any = None) -> Callable:
    """prefill(params, batch, caches) -> (last-token logits, caches).
    Encoder-only models take no caches and return per-frame logits."""
    if cfg.encoder_only:
        @torch.no_grad()
        def prefill_enc(params, batch):
            with span("repro.encode"):
                logits, _, _ = forward(params, cfg, _placed(batch, dist),
                                       dist=dist)
                return _whole(logits)
        return prefill_enc

    @torch.no_grad()
    def prefill(params, batch, caches):
        logits, new_caches, _ = forward(params, cfg, _placed(batch, dist),
                                        caches=caches, cache_index=0,
                                        dist=dist)
        return _whole(logits, last=True), new_caches

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
    ``init_paged_caches``; under ``dist`` its pools replicated, the page
    table and per-slot indices global)."""
    if decode_kernel is not None:
        cfg = cfg.with_(decode_kernel=decode_kernel)

    def _finish(logits):
        logits = _whole(logits, last=True)
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
                params, cfg, _placed({"tokens": tokens}, dist), caches=caches,
                cache_index=cache_index, pages=pages, dist=dist)
            logits, next_id = _finish(logits)
            return logits, next_id, new_caches
        return serve_step

    @torch.no_grad()
    def serve_step(params, tokens, caches, cache_index):
        logits, new_caches, _ = forward(params, cfg,
                                        _placed({"tokens": tokens}, dist),
                                        caches=caches,
                                        cache_index=cache_index, dist=dist)
        logits, next_id = _finish(logits)
        return logits, next_id, new_caches

    return serve_step


def make_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device: str | torch.device = "cuda"):
    return init_caches(cfg, batch, max_len, torch_dtype(cfg.dtype), device)
