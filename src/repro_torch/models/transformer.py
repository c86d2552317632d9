"""The composable model stack.

Port of ``repro/models/transformer.py``: the ``attn``/``local`` layer
kinds (GQA attention, or MLA where ``cfg.mla`` is set), the Mamba-2 ``ssd``
kind and the RG-LRU ``rglru`` kind, each with an FFN where the reference's
``_has_mlp`` rule gives one (always for attention; for the recurrent kinds
only when ``d_ff > 0``), a dense MLP or, where ``cfg.moe`` is set, the
MoE; and the stub modality frontends: ``audio_frames`` (encoder-only,
frames in place of tokens) and ``vit_patches`` (projected patches before
the text). Layers are generated from ``cfg.layer_pattern`` cycled over
``n_layers``; the parameters and caches of the full periods are stacked on
a leading ``layers`` axis, as in the reference, so one
:func:`repro_torch.convert.tree_to_torch` carries a JAX tree across. Where
the reference runs ``lax.scan`` over that axis, the port runs a Python loop
that indexes it. Remainder layers (``n_layers % period``) follow under
``"tail"``.

Not ported yet, raising ``NotImplementedError`` with its ROADMAP item:
``dist`` (Queue 1, item 8). As in the reference, MLA has no paged cache.
"""
from __future__ import annotations

from typing import Any

import torch

from .attention import attention_block, attention_spec, init_kv_cache
from .config import ModelConfig
from .layers import (embed, embedding_spec, mlp, mlp_spec, rmsnorm,
                     rmsnorm_spec, torch_dtype, unembed)
from .mla import init_mla_cache, mla_block, mla_spec
from .moe import moe_block, moe_spec
from .params import ParamSpec, stack_specs
from .rglru import init_rglru_cache, rglru_block, rglru_spec
from .ssd import init_ssd_cache, ssd_block, ssd_spec

_SHARDED = "sharded execution (dist) comes with the sharded slice: " \
           "ROADMAP.md Queue 1, item 8"


def _has_mlp(cfg: ModelConfig, kind: str) -> bool:
    if kind in ("attn", "local"):
        return True
    return cfg.d_ff > 0


def block_spec(cfg: ModelConfig, kind: str) -> dict:
    d = cfg.d_model
    spec: dict = {"norm1": rmsnorm_spec(d)}
    if kind in ("attn", "local"):
        spec["mix"] = mla_spec(cfg) if cfg.mla is not None \
            else attention_spec(cfg)
    elif kind == "ssd":
        spec["mix"] = ssd_spec(cfg)
    elif kind == "rglru":
        spec["mix"] = rglru_spec(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    if _has_mlp(cfg, kind):
        spec["norm2"] = rmsnorm_spec(d)
        spec["ffn"] = moe_spec(cfg) if cfg.moe is not None else mlp_spec(cfg)
    return spec


def block_apply(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                positions: torch.Tensor | int = 0,
                cache: dict | None = None,
                cache_index: torch.Tensor | None = None,
                dist: Any = None,
                decode: bool = False,
                pages: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """One residual block. Returns (x, new_cache, aux_loss): the MoE's
    router loss, a float32 scalar in the autograd graph, or the Python
    float 0.0 for a block without a MoE."""
    if dist is not None:
        raise NotImplementedError(_SHARDED)
    aux = 0.0
    h = rmsnorm(params["norm1"], x, cfg.rms_eps)
    if kind in ("attn", "local"):
        if cfg.mla is not None:
            y, new_cache = mla_block(params["mix"], cfg, h,
                                     positions=positions, cache=cache,
                                     cache_index=cache_index)
        else:
            y, new_cache = attention_block(params["mix"], cfg, h, kind=kind,
                                           positions=positions, cache=cache,
                                           cache_index=cache_index,
                                           pages=pages)
    elif kind == "ssd":
        y, new_cache = ssd_block(params["mix"], cfg, h, cache=cache)
    elif kind == "rglru":
        y, new_cache = rglru_block(params["mix"], cfg, h, cache=cache)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    x = x + y
    if _has_mlp(cfg, kind):
        h = rmsnorm(params["norm2"], x, cfg.rms_eps)
        if cfg.moe is not None:
            f, aux = moe_block(params["ffn"], cfg, h, impl="capacity",
                               dropless=decode)
        else:
            f = mlp(params["ffn"], cfg, h)
        x = x + f
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Full-model spec
# ---------------------------------------------------------------------------


def model_spec(cfg: ModelConfig) -> dict:
    period_spec = {str(i): block_spec(cfg, k)
                   for i, k in enumerate(cfg.layer_pattern)}
    spec: dict = {
        "embed": embedding_spec(cfg),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if cfg.n_periods > 0:
        spec["periods"] = stack_specs(period_spec, cfg.n_periods)
    if cfg.n_remainder:
        spec["tail"] = {str(i): block_spec(cfg, cfg.layer_pattern[i])
                        for i in range(cfg.n_remainder)}
    if cfg.frontend is not None:
        spec["frontend"] = {
            "w": ParamSpec((cfg.frontend.input_dim, cfg.d_model),
                           ("ff", "embed"), init="lecun"),
            "b": ParamSpec((cfg.d_model,), ("embed",), init="zeros"),
        }
    return spec


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _index(tree: Any, i: int) -> Any:
    """Slice ``i`` of the leading (periods) axis of every leaf: views, so
    in-place cache writes land in the stacked tensors."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_period(params_p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                  positions, caches_p, cache_index, decode=False, pages=None):
    """Apply one period (len(layer_pattern) blocks). caches_p: dict per slot."""
    aux = 0.0
    for i, kind in enumerate(cfg.layer_pattern):
        c = caches_p.get(str(i)) if caches_p is not None else None
        x, _, a = block_apply(params_p[str(i)], cfg, kind, x,
                              positions=positions, cache=c,
                              cache_index=cache_index, decode=decode,
                              pages=pages)
        aux = aux + a
    return x, aux


def _project(params: dict, cfg: ModelConfig, embeds: torch.Tensor
             ) -> torch.Tensor:
    """The frontend's linear map of (B, S, input_dim) features, in the
    working dtype."""
    dt = torch_dtype(cfg.dtype)
    return embeds.to(dt) @ params["frontend"]["w"] + params["frontend"]["b"]


def _embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                  ) -> tuple[torch.Tensor, int]:
    """(the stack's input (B, S, d), the count of prefix positions that
    the logits leave out)."""
    kind = cfg.frontend.kind if cfg.frontend is not None else None
    if kind == "audio_frames":
        return _project(params, cfg, batch["embeds"]), 0
    x = embed(params["embed"], cfg, batch["tokens"])
    if kind == "vit_patches" and batch.get("embeds") is not None:
        x_img = _project(params, cfg, batch["embeds"])
        return torch.cat([x_img, x], dim=1), x_img.shape[1]
    return x, 0


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            caches: dict | None = None,
            cache_index: torch.Tensor | None = None,
            dist: Any = None,
            return_hidden: bool = False,
            pages: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Run the stack.

    ``batch``: {"tokens": (B, S) int} and/or {"embeds": (B, S, input_dim)}
    for the frontends: ``audio_frames`` takes frames in place of tokens,
    ``vit_patches`` puts the projected patches before the text (decode
    steps carry no patches). ``caches``: {"periods": stacked caches,
    "tail": {...}} or None; decode writes them in place and returns the same
    tree. ``pages``: (B, pages_per_slot) int32 page table when ``caches``
    came from :func:`init_paged_caches` (shared by every paged layer).
    Returns (logits (B, S, padded_vocab) over the text positions only for
    a VLM, caches or None, aux_loss).
    """
    if dist is not None:
        raise NotImplementedError(_SHARDED)
    decode = caches is not None
    x, n_prefix = _embed_inputs(params, cfg, batch)
    positions: torch.Tensor | int = cache_index if decode else 0
    aux_total = 0.0

    if cfg.n_periods > 0:
        caches_p = caches.get("periods") if decode else None
        for i in range(cfg.n_periods):
            x, a = _apply_period(
                _index(params["periods"], i), cfg, x, positions=positions,
                caches_p=_index(caches_p, i) if caches_p is not None else None,
                cache_index=cache_index, decode=decode, pages=pages)
            aux_total = aux_total + a

    if cfg.n_remainder:
        caches_t = caches.get("tail") if decode else None
        for i in range(cfg.n_remainder):
            kind = cfg.layer_pattern[i]
            c = caches_t.get(str(i)) if caches_t is not None else None
            x, _, a = block_apply(params["tail"][str(i)], cfg, kind, x,
                                  positions=positions, cache=c,
                                  cache_index=cache_index, decode=decode,
                                  pages=pages)
            aux_total = aux_total + a

    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if n_prefix:
        x = x[:, n_prefix:]  # loss/logits over text positions only (VLM)
    # a MoE's aux stays in the graph (the router's gradient); a model
    # without one gives a float32 zero
    aux_total = aux_total.float() if isinstance(aux_total, torch.Tensor) \
        else torch.tensor(aux_total, dtype=torch.float32)
    if return_hidden:
        return x, (caches if decode else None), aux_total
    logits = unembed(params["embed"], cfg, x)
    return logits, (caches if decode else None), aux_total


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------


def _stacked(tree: dict, n: int) -> dict:
    return {k: torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                           device="meta") for k, v in tree.items()}


def _build_caches(cfg: ModelConfig, make) -> dict:
    """Cache tree in the stacked layout of :func:`forward`; ``make(kind)``
    builds one layer's cache on the ``meta`` device (shapes only)."""
    out: dict = {}
    if cfg.n_periods > 0:
        out["periods"] = {str(i): _stacked(make(kind), cfg.n_periods)
                          for i, kind in enumerate(cfg.layer_pattern)}
    if cfg.n_remainder:
        out["tail"] = {str(i): make(cfg.layer_pattern[i])
                       for i in range(cfg.n_remainder)}
    return out


def _cache_for(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype: torch.dtype) -> dict:
    """One layer's decode cache on the ``meta`` device."""
    if kind == "ssd":
        return init_ssd_cache(cfg, batch, dtype, "meta")
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, dtype, "meta")
    if cfg.mla is not None:
        return init_mla_cache(cfg, batch, max_len, dtype, "meta")
    return init_kv_cache(cfg, kind, batch, max_len, dtype, "meta")


def _materialize(tree: dict, device: torch.device) -> dict:
    if isinstance(tree, dict):
        return {k: _materialize(v, device) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype,
                device: str | torch.device = "cuda") -> dict:
    """Decode cache tree matching the stacked layout of :func:`forward`."""
    from repro_torch.convert import resolve_device
    dev = resolve_device(device)
    shapes = _build_caches(cfg, lambda kind: _cache_for(
        cfg, kind, batch, max_len, dtype))
    return _materialize(shapes, dev)


def paged_layout(max_len: int, page_size: int, batch: int,
                 n_pages: int | None = None) -> tuple[int, int]:
    """(pages_per_slot, pool_pages) for a paged cache. The default pool is
    full-reservation-equivalent plus the reserved trash page; serving passes
    a smaller pool to oversubscribe (long-context slots no longer reserve
    ``max_len`` up front)."""
    pages_per_slot = -(-max_len // page_size)
    if n_pages is None:
        n_pages = batch * pages_per_slot + 1
    return pages_per_slot, n_pages


def _paged_cache_for(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, *, page_size: int, n_pages: int) -> dict:
    if kind in ("ssd", "rglru") or (
            kind == "local" and min(max_len, cfg.window_size) < max_len):
        # ring buffers are already O(window), recurrent state O(1); keep
        # them dense.
        return _cache_for(cfg, kind, batch, max_len, dtype)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"pool_k": torch.empty(shape, dtype=dtype, device="meta"),
            "pool_v": torch.empty(shape, dtype=dtype, device="meta")}


def init_paged_caches(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype, *, page_size: int = 64,
                      n_pages: int | None = None,
                      device: str | torch.device = "cuda") -> dict:
    """Decode cache tree with paged KV for the full-context attention
    layers: physical pools ``(n_pages, page_size, K, Dh)`` indexed through
    the page table that :func:`forward` takes as ``pages``. Ring (local)
    and recurrent (ssd/rglru) caches keep their dense layout — they are
    already O(window) / O(1) per slot. Page 0 is reserved as the trash page
    for writes from unbound slots. MLA's latent caches have no paged
    layout, in the reference either."""
    if cfg.mla is not None:
        raise NotImplementedError("paged KV cache with MLA latent caches")
    from repro_torch.convert import resolve_device
    dev = resolve_device(device)
    _, n_pages = paged_layout(max_len, page_size, batch, n_pages)
    shapes = _build_caches(cfg, lambda kind: _paged_cache_for(
        cfg, kind, batch, max_len, dtype, page_size=page_size,
        n_pages=n_pages))
    return _materialize(shapes, dev)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 dtype: torch.dtype) -> Any:
    """The decode cache tree as ``meta`` tensors (shapes and dtypes only)."""
    return _build_caches(cfg, lambda kind: _cache_for(
        cfg, kind, batch, max_len, dtype))
