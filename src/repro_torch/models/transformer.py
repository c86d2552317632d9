"""The composable model stack.

Port of ``repro/models/transformer.py`` for the ``attn``/``local`` layer
kinds with a dense MLP and the Mamba-2 ``ssd`` kind (with an MLP only where
the reference's ``_has_mlp`` rule gives one: never for ``d_ff = 0``).
Layers are generated from ``cfg.layer_pattern`` cycled over ``n_layers``;
the parameters and caches of the full periods are
stacked on a leading ``layers`` axis, as in the reference, so one
:func:`repro_torch.convert.tree_to_torch` carries a JAX tree across. Where
the reference runs ``lax.scan`` over that axis, the port runs a Python loop
that indexes it. Remainder layers (``n_layers % period``) follow under
``"tail"``.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
the ``rglru`` kind (Queue 1, item 5), MoE, MLA and the frontends (item 7),
and ``dist`` (item 8).
"""
from __future__ import annotations

from typing import Any

import torch

from .attention import attention_block, attention_spec, init_kv_cache
from .config import ModelConfig
from .layers import (embed, embedding_spec, mlp, mlp_spec, rmsnorm,
                     rmsnorm_spec, unembed)
from .params import stack_specs
from .ssd import init_ssd_cache, ssd_block, ssd_spec

_RECURRENT = "the rglru layer comes with the rest of the recurrent slice: " \
             "ROADMAP.md Queue 1, item 5"
_MOE_MLA_FRONTEND = "MoE, MLA and the modality frontends come with a later " \
                    "slice: ROADMAP.md Queue 1, item 7"
_SHARDED = "sharded execution (dist) comes with the sharded slice: " \
           "ROADMAP.md Queue 1, item 8"


def _check_supported(cfg: ModelConfig, kind: str | None = None) -> None:
    if kind == "rglru":
        raise NotImplementedError(_RECURRENT)
    if kind is not None and kind not in ("attn", "local", "ssd"):
        raise ValueError(f"unknown layer kind {kind}")
    if cfg.moe is not None or cfg.mla is not None or cfg.frontend is not None:
        raise NotImplementedError(_MOE_MLA_FRONTEND)


def _has_mlp(cfg: ModelConfig, kind: str) -> bool:
    if kind in ("attn", "local"):
        return True
    return cfg.d_ff > 0


def block_spec(cfg: ModelConfig, kind: str) -> dict:
    _check_supported(cfg, kind)
    d = cfg.d_model
    spec: dict = {"norm1": rmsnorm_spec(d),
                  "mix": ssd_spec(cfg) if kind == "ssd"
                  else attention_spec(cfg)}
    if _has_mlp(cfg, kind):
        spec["norm2"] = rmsnorm_spec(d)
        spec["ffn"] = mlp_spec(cfg)
    return spec


def block_apply(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
                positions: torch.Tensor | int = 0,
                cache: dict | None = None,
                cache_index: torch.Tensor | None = None,
                dist: Any = None,
                decode: bool = False,
                pages: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """One residual block. Returns (x, new_cache, aux_loss); the aux loss of
    a dense MLP block is the Python float 0.0 (MoE blocks come later)."""
    _check_supported(cfg, kind)
    if dist is not None:
        raise NotImplementedError(_SHARDED)
    aux = 0.0
    h = rmsnorm(params["norm1"], x, cfg.rms_eps)
    if kind == "ssd":
        y, new_cache = ssd_block(params["mix"], cfg, h, cache=cache)
    else:
        y, new_cache = attention_block(params["mix"], cfg, h, kind=kind,
                                       positions=positions, cache=cache,
                                       cache_index=cache_index, pages=pages)
    x = x + y
    if _has_mlp(cfg, kind):
        h = rmsnorm(params["norm2"], x, cfg.rms_eps)
        x = x + mlp(params["ffn"], cfg, h)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# Full-model spec
# ---------------------------------------------------------------------------


def model_spec(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
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


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            caches: dict | None = None,
            cache_index: torch.Tensor | None = None,
            dist: Any = None,
            return_hidden: bool = False,
            pages: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """Run the stack.

    ``batch``: {"tokens": (B, S) int}. ``caches``: {"periods": stacked
    caches, "tail": {...}} or None; decode writes them in place and returns
    the same tree. ``pages``: (B, pages_per_slot) int32 page table when
    ``caches`` came from :func:`init_paged_caches` (shared by every paged
    layer). Returns (logits (B, S, padded_vocab), caches or None, aux_loss).
    """
    _check_supported(cfg)
    if dist is not None:
        raise NotImplementedError(_SHARDED)
    decode = caches is not None
    x = embed(params["embed"], cfg, batch["tokens"])
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
    aux_total = torch.tensor(aux_total, dtype=torch.float32)
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
    _check_supported(cfg)
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
    if kind == "ssd" or (kind == "local"
                         and min(max_len, cfg.window_size) < max_len):
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
    and recurrent (ssd) caches keep their dense layout — they are already
    O(window) / O(1) per slot. Page 0 is reserved as the trash page for
    writes from unbound slots."""
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
