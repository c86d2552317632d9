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

``remat`` checkpoints each period as the reference checkpoints its scan
body (:func:`period_runner`); the remainder layers and the unembedding are
not checkpointed. ``dist`` (a :class:`repro_torch.sharding.DistContext`)
runs the sharded step: the embedding as the vocab-parallel island, each
block as a region on the rank's batch shard with the MoE as the
expert-parallel island, the activations constrained after the embedding
and after each block, and the logits left vocab-sharded. Sharded decode
(caches with ``dist``) comes with the last sharded slice (ROADMAP.md
Queue 1, item 8). As in the reference, MLA has no paged cache.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.tree import tree_map

from .attention import attention_block, attention_spec, init_kv_cache
from .config import ModelConfig
from .layers import (embed, embedding_spec, mlp, mlp_spec, rmsnorm,
                     rmsnorm_spec, torch_dtype, unembed)
from .mla import init_mla_cache, mla_block, mla_spec
from .moe import moe_block, moe_spec
from .params import ParamSpec, stack_specs
from .rglru import init_rglru_cache, rglru_block, rglru_spec
from .ssd import init_ssd_cache, ssd_block, ssd_spec

_SHARDED_DECODE = "sharded decode (dist with caches) comes with the last " \
                  "sharded slice: ROADMAP.md Queue 1, item 8"

_aten = torch.ops.aten
# what each remat policy saves inside a period (the reference's
# jax.checkpoint policies): "full" nothing; "dots" every matmul's output;
# "dots_no_batch" the products without a batch dim. Everything else is
# recomputed in the backward.
REMAT_SAVES = {
    "full": frozenset(),
    "dots": frozenset({_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}),
    "dots_no_batch": frozenset({_aten.mm, _aten.addmm}),
}


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
    float 0.0 for a block without a MoE. With ``dist``, ``x`` and the
    params are DTensors (:func:`_block_dist`)."""
    if dist is not None:
        if cache is not None:
            raise NotImplementedError(_SHARDED_DECODE)
        return _block_dist(params, cfg, kind, x, dist)
    aux = 0.0
    x = _mixer(params, cfg, kind, x, positions=positions, cache=cache,
               cache_index=cache_index, pages=pages)
    if _has_mlp(cfg, kind):
        h = rmsnorm(params["norm2"], x, cfg.rms_eps)
        if cfg.moe is not None:
            f, aux = moe_block(params["ffn"], cfg, h, impl="capacity",
                               dropless=decode)
        else:
            f = mlp(params["ffn"], cfg, h)
        x = x + f
    return x, cache, aux


def _mixer(params: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, *,
           positions=0, cache=None, cache_index=None, pages=None,
           reduce: Callable | None = None) -> torch.Tensor:
    """x + the block's mixing layer (attention, MLA, SSD or RG-LRU) of its
    first norm; caches are written in place. ``reduce`` sums a layer
    output that is partial over the tensor-parallel ranks."""
    h = rmsnorm(params["norm1"], x, cfg.rms_eps)
    if kind in ("attn", "local"):
        if cfg.mla is not None:
            y, _ = mla_block(params["mix"], cfg, h, positions=positions,
                             cache=cache, cache_index=cache_index)
        else:
            y, _ = attention_block(params["mix"], cfg, h, kind=kind,
                                   positions=positions, cache=cache,
                                   cache_index=cache_index, pages=pages)
    elif kind == "ssd":
        y, _ = ssd_block(params["mix"], cfg, h, cache=cache)
    elif kind == "rglru":
        y, _ = rglru_block(params["mix"], cfg, h, cache=cache)
    else:
        raise ValueError(f"unknown layer kind {kind}")
    return x + (y if reduce is None else reduce(y))


def _heads_split(cfg: ModelConfig, mix: dict, dist) -> bool:
    """Whether a sharded attention block runs its heads tensor-parallel:
    the rules shard the query heads over ``model`` and each rank's KV
    heads are whole (sharded alike, or one KV head's group holds all of
    the rank's query heads)."""
    tp = dist.tp_axis
    if cfg.mla is not None or dist.model_spec(mix["wq"])[1] != tp:
        return False
    if dist.model_spec(mix["wk"])[1] == tp:
        return True
    per_rank = cfg.n_heads // dist.tp_size
    return (cfg.n_heads // cfg.n_kv_heads) % per_rank == 0


def _rank_kv(mix: dict, cfg: ModelConfig, dist) -> dict:
    """The rank's attention weights: its query heads' KV head cut from a
    K/V projection the rules leave whole."""
    wq, wk = mix["wq"], mix["wk"]
    if wq.shape[1] == cfg.n_heads or wk.shape[1] < cfg.n_kv_heads:
        return mix                      # one rank, or K/V sharded alike
    group = cfg.n_heads // cfg.n_kv_heads
    k0 = dist.axis_index(dist.tp_axis) * wq.shape[1] // group
    return {**mix, "wk": wk[:, k0:k0 + 1], "wv": mix["wv"][:, k0:k0 + 1]}


def _block_dist(params: dict, cfg: ModelConfig, kind: str, x, dist
                ) -> tuple[Any, None, Any]:
    """The sharded block: the mixing layer and a dense FFN as one region
    on the rank's batch shard (the kernels launch there on local tensors),
    a MoE as :meth:`DistContext.moe_island`, the result constrained to the
    batch sharding. Attention heads and MLP columns that the rules shard
    over ``model`` stay sharded in the region (each rank computes its
    heads or columns; one all-reduce sums the layer's output); every other
    weight is gathered whole."""
    from repro_torch.sharding.rules import P
    aux = 0.0
    moe = _has_mlp(cfg, kind) and cfg.moe is not None
    dense = {k: v for k, v in params.items() if not (moe and k == "ffn")}
    mix_tp = kind in ("attn", "local") and _heads_split(cfg, params["mix"],
                                                        dist)
    mlp_tp = "ffn" in dense and \
        dist.model_spec(dense["ffn"]["w_down"])[0] == dist.tp_axis
    split = {"mix": mix_tp, "ffn": mlp_tp}
    specs = {k: tree_map(dist.model_spec if split.get(k) else lambda _: P(),
                         v) for k, v in dense.items()}

    def reduce(y):
        return dist.psum(y, dist.tp_axis)

    def region(xl, p):
        if mix_tp:
            p = {**p, "mix": _rank_kv(p["mix"], cfg, dist)}
        xl = _mixer(p, cfg, kind, xl, reduce=reduce if mix_tp else None)
        if not _has_mlp(cfg, kind):
            return xl
        h = rmsnorm(p["norm2"], xl, cfg.rms_eps)
        if moe:
            return xl, h
        f = mlp(p["ffn"], cfg, h)
        return xl + (reduce(f) if mlp_tp else f)

    if moe:
        x, h = dist.dense(region, [x], dense, n_out=2, param_specs=specs)
        f, aux = dist.moe_island(params["ffn"], cfg, h)
        x = x + f
    else:
        x = dist.dense(region, [x], dense, param_specs=specs)
    return dist.constrain_activation(x), None, aux


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
                  positions, caches_p, cache_index, dist=None, decode=False,
                  pages=None):
    """Apply one period (len(layer_pattern) blocks). caches_p: dict per slot."""
    aux = 0.0
    for i, kind in enumerate(cfg.layer_pattern):
        c = caches_p.get(str(i)) if caches_p is not None else None
        x, _, a = block_apply(params_p[str(i)], cfg, kind, x,
                              positions=positions, cache=c,
                              cache_index=cache_index, dist=dist,
                              decode=decode, pages=pages)
        aux = aux + a
    return x, aux


def _save_policy(saves: frozenset, ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op.overloadpacket in saves \
        else CheckpointPolicy.PREFER_RECOMPUTE


def period_runner(remat: str) -> Callable:
    """:func:`_apply_period`, checkpointed as ``remat`` says: "none" runs
    it as it is; "full" saves only the period's inputs
    (``torch.utils.checkpoint``); "dots" and "dots_no_batch" also save the
    outputs of the products in :data:`REMAT_SAVES` (selective
    checkpointing). An unknown name raises ``KeyError``, as the
    reference's policy lookup does. The hand kernels are autograd
    functions that no policy can see into: every policy runs their forward
    again in the backward."""
    if remat == "none":
        return _apply_period
    saves = REMAT_SAVES[remat]
    context_fn = None
    if saves:
        context_fn = partial(create_selective_checkpoint_contexts,
                             partial(_save_policy, saves))

    def run(params_p, cfg, x, **kw):
        if not torch.is_grad_enabled():
            return _apply_period(params_p, cfg, x, **kw)
        fn = partial(_apply_period, cfg=cfg, **kw)
        if context_fn is None:
            return checkpoint(fn, params_p, x=x, use_reentrant=False)
        return checkpoint(fn, params_p, x=x, use_reentrant=False,
                          context_fn=context_fn)
    return run


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


def _embed_inputs_dist(params: dict, cfg: ModelConfig, batch: dict, dist
                       ) -> tuple[Any, int]:
    """:func:`_embed_inputs` on the mesh: token rows through the
    vocab-parallel embedding, a frontend's projection as a region."""
    kind = cfg.frontend.kind if cfg.frontend is not None else None
    front = {"frontend": params["frontend"]} if kind is not None else None
    if kind == "audio_frames":
        return dist.dense(lambda e, p: _project(p, cfg, e),
                          [batch["embeds"]], front), 0
    x = dist.embed(params["embed"]["embedding"], cfg, batch["tokens"])
    if kind == "vit_patches" and batch.get("embeds") is not None:
        n_prefix = batch["embeds"].shape[1]
        return dist.dense(
            lambda e, xt, p: torch.cat([_project(p, cfg, e), xt], dim=1),
            [batch["embeds"], x], front), n_prefix
    return x, 0


def _head_dist(params: dict, cfg: ModelConfig, x, n_prefix: int, dist,
               return_hidden: bool):
    """The final norm and the unembedding as one region: logits (B, S, V)
    vocab-sharded over ``model`` where it divides the vocab."""
    from repro_torch.sharding.rules import P
    tp = dist.tp_axis if cfg.padded_vocab % dist.tp_size == 0 else None
    bax = dist.batch_pspec(3, x.shape[0])[0]
    head = {"final_norm": params["final_norm"]}
    specs = {"final_norm": {"scale": P(None)}}
    if not return_hidden:
        if cfg.tie_embeddings:
            head["embedding"] = params["embed"]["embedding"]
            specs["embedding"] = P(tp, None)
        else:
            head["unembed"] = params["embed"]["unembed"]
            specs["unembed"] = P(None, tp)

    def region(xl, p):
        xl = rmsnorm(p["final_norm"], xl, cfg.rms_eps)
        if n_prefix:
            xl = xl[:, n_prefix:]  # loss/logits over text positions only
        return xl if return_hidden else unembed(p, cfg, xl)

    out = P(bax, None, None) if return_hidden else P(bax, None, tp)
    return dist.local(region, [x], [P(bax, None, None)], [out], head, specs)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            caches: dict | None = None,
            cache_index: torch.Tensor | None = None,
            dist: Any = None,
            remat: str = "none",
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
    ``remat``: "none" | "full" | "dots" | "dots_no_batch"
    (:func:`period_runner`). ``dist``: params and batch are DTensors placed
    by ``dist``; the logits come back as a DTensor, vocab-sharded.
    Returns (logits (B, S, padded_vocab) over the text positions only for
    a VLM, caches or None, aux_loss).
    """
    decode = caches is not None
    if dist is not None and decode:
        raise NotImplementedError(_SHARDED_DECODE)
    run_period = period_runner(remat)
    if dist is None:
        x, n_prefix = _embed_inputs(params, cfg, batch)
        index = _index
    else:
        x, n_prefix = _embed_inputs_dist(params, cfg, batch, dist)
        x = dist.constrain_activation(x)
        index = dist.index
    positions: torch.Tensor | int = cache_index if decode else 0
    aux_total = 0.0

    if cfg.n_periods > 0:
        caches_p = caches.get("periods") if decode else None
        for i in range(cfg.n_periods):
            x, a = run_period(
                index(params["periods"], i), cfg, x, positions=positions,
                caches_p=_index(caches_p, i) if caches_p is not None else None,
                cache_index=cache_index, dist=dist, decode=decode,
                pages=pages)
            aux_total = aux_total + a

    if cfg.n_remainder:
        caches_t = caches.get("tail") if decode else None
        for i in range(cfg.n_remainder):
            kind = cfg.layer_pattern[i]
            c = caches_t.get(str(i)) if caches_t is not None else None
            x, _, a = block_apply(params["tail"][str(i)], cfg, kind, x,
                                  positions=positions, cache=c,
                                  cache_index=cache_index, dist=dist,
                                  decode=decode, pages=pages)
            aux_total = aux_total + a

    # a MoE's aux stays in the graph (the router's gradient); a model
    # without one gives a float32 zero
    dev = (x.to_local() if dist is not None else x).device
    aux_total = aux_total.float() if isinstance(aux_total, torch.Tensor) \
        else torch.tensor(aux_total, dtype=torch.float32, device=dev)
    if dist is not None:
        return _head_dist(params, cfg, x, n_prefix, dist, return_hidden), \
            None, aux_total
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if n_prefix:
        x = x[:, n_prefix:]  # loss/logits over text positions only (VLM)
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
