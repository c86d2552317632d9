"""Step builders: prefill and serve. Port of ``repro/train/step.py``.

``make_train_step`` (and ``TrainState``, the loss and the optimizer) waits
for the training slice, ``ROADMAP.md`` Queue 1, item 6. ``dist`` is not
accepted yet (item 8).

The reference wraps these steps in ``jax.jit``; PyTorch runs them eagerly.
A step writes the decode caches in place and returns the same tree.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import forward, init_caches


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
