"""Attention: GQA with chunked online softmax, and the decode paths over
dense, ring and paged KV caches.

Port of ``repro/models/attention.py``. One code path serves whole-sequence
forward and decode:

* KV is processed in chunks with running (max, sum, acc) statistics;
* ``q_offset`` may be per slot (continuous batching);
* ``window`` gives sliding-window (local) attention: the banded path for
  whole sequences, and a ring-buffer cache of ``window`` rows for decode;
* ``decode_kernel="flash"`` sends single-token decode to the flash-decode
  kernels (:mod:`repro_torch.kernels.flash_decode`), dense and paged;
* the whole-sequence forward without caches (training, encoder-only) goes
  through :func:`repro_torch.kernels.flash_attention.flash_attention`: the
  flash-attention kernel for a CUDA tensor, :func:`chunked_attention` with
  the same arguments for a CPU tensor.

Caches are written **in place**: the new token's K/V is stored into the
cache tensors and the returned cache dict holds the same tensors. (The
reference's arrays are immutable and it returns new ones.) The serving
engine's stall rollback accounts for that.

Transcribed, not fixed: :func:`chunked_attention` does not mask ``p`` (the
reference's ``attention.py:137``), so a query with no valid key gets a
garbage average, not zeros; the flash kernels' contract is zeros there.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels.flash_attention import flash_attention

from .config import ModelConfig
from .layers import rmsnorm, rope_angles, rotate, torch_dtype
from .params import ParamSpec

NEG_INF = -1e30


def attention_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    spec = {
        "wq": ParamSpec((d, cfg.n_heads, cfg.head_dim),
                        ("embed", "heads", "head_dim"), init="lecun"),
        "wk": ParamSpec((d, cfg.n_kv_heads, cfg.head_dim),
                        ("embed", "kv_heads", "head_dim"), init="lecun"),
        "wv": ParamSpec((d, cfg.n_kv_heads, cfg.head_dim),
                        ("embed", "kv_heads", "head_dim"), init="lecun"),
        "wo": ParamSpec((cfg.n_heads, cfg.head_dim, d),
                        ("heads", "head_dim", "embed"), init="lecun"),
    }
    if cfg.use_qk_norm:
        spec["q_norm"] = {"scale": ParamSpec((cfg.head_dim,), (None,), init="ones")}
        spec["k_norm"] = {"scale": ParamSpec((cfg.head_dim,), (None,), init="ones")}
    return spec


def _expand_positions(q_offset: torch.Tensor | int, b: int, s: int,
                      device: torch.device) -> torch.Tensor:
    """-> (B, S) int32 absolute positions."""
    base = torch.arange(s, dtype=torch.int32, device=device)
    if isinstance(q_offset, int):
        return (base[None, :] + q_offset).expand(b, s)
    q_offset = torch.as_tensor(q_offset, dtype=torch.int32, device=device)
    if q_offset.dim() == 0:
        return (base[None, :] + q_offset).expand(b, s)
    return q_offset[:, None] + base[None, :]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_offset: torch.Tensor | int = 0,
                      k_positions: torch.Tensor | None = None,
                      causal: bool = True,
                      window: int | None = None,
                      kv_chunk: int = 1024,
                      k_valid: torch.Tensor | None = None,
                      scale: float | None = None,
                      return_stats: bool = False,
                      score_dtype: torch.dtype = torch.float32):
    """q: (B, Sq, H, Dk); k: (B, Sk, K, Dk); v: (B, Sk, K, Dv), H % K == 0.

    ``k_positions``: (B, Sk) absolute positions of cache rows (ring caches);
    default is ``arange(Sk)``. ``k_valid``: (B, Sk) filled-row mask.
    Returns (B, Sq, H, Dv); accumulates in float32. ``return_stats``: also
    the running max and normalizer, (B, Sq, H) float32 each, so that a
    caller can merge partial attentions over key shards (the
    sequence-parallel decode island); the banded path is not taken then.
    """
    b, sq, h, dh = q.shape
    _, sk, kh, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    dev = q.device
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qh = q.reshape(b, sq, kh, g, dh)
    q_pos = _expand_positions(q_offset, b, sq, dev)

    c = min(kv_chunk, sk)
    n_chunks = -(-sk // c)
    pad = n_chunks * c - sk
    if k_positions is None:
        k_positions = torch.arange(sk, dtype=torch.int32,
                                   device=dev).expand(b, sk)
    if k_valid is None:
        k_valid = torch.ones((b, sk), dtype=torch.bool, device=dev)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad), value=-1)
        k_valid = torch.nn.functional.pad(k_valid, (0, pad))

    # banded fast path: whole-sequence sliding-window attention touches only
    # the KV band [q_chunk_start - window, q_chunk_end).
    if (window is not None and causal and sq > 1 and sk == sq and sk > c
            and pad == 0 and dv == dh and not return_stats):
        return _banded_local_attention(qh, k, v, q_pos, window=window,
                                       chunk=c, scale=scale, sq=sq)

    sdt = score_dtype
    neg = NEG_INF if sdt == torch.float32 else -6e4  # bf16-representable
    m_run = torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, sq, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kh, g, dv), dtype=torch.float32, device=dev)
    qp = q_pos[:, :, None]                    # (B, Sq, 1)
    for i in range(n_chunks):
        blk = slice(i * c, (i + 1) * c)
        kc, vc = k[:, blk], v[:, blk]
        kp = k_positions[:, blk][:, None, :]  # (B, 1, C)
        s = torch.einsum("bqkgd,bckd->bqkgc", qh.to(sdt), kc.to(sdt)) * \
            torch.tensor(scale, dtype=sdt, device=dev)
        mask = k_valid[:, blk][:, None, :] & (kp >= 0)
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.tensor(neg, dtype=sdt, device=dev))
        m_new = torch.maximum(m_run, s.amax(dim=-1).float())
        # probabilities stay in score_dtype; running stats stay float32. p
        # is not masked, as in the reference.
        p = torch.exp(s - m_new[..., None].to(sdt))
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1, dtype=torch.float32)
        pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(vc.dtype).float(),
                          vc.float())
        acc = acc * corr[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp_min(l_run[..., None], 1e-37)
    out = out.reshape(b, sq, h, dv).to(q.dtype)
    if return_stats:
        return out, m_run.reshape(b, sq, h), l_run.reshape(b, sq, h)
    return out


def _banded_local_attention(qh: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, q_pos: torch.Tensor, *,
                            window: int, chunk: int, scale: float,
                            sq: int) -> torch.Tensor:
    """Sliding-window attention computing only the needed KV band per
    q-chunk. qh: (B, Sq, K, G, Dh), Sq divisible by ``chunk``."""
    b, _, kh, g, dh = qh.shape
    c = chunk
    n_q = sq // c
    band = -(-window // c) * c + c  # kv band length per q chunk (>= window+c)
    # left-pad k/v so the band slice is always in range
    kpad = torch.nn.functional.pad(k, (0, 0, 0, 0, band - c, 0))
    vpad = torch.nn.functional.pad(v, (0, 0, 0, 0, band - c, 0))
    dev = qh.device
    outs = []
    for i in range(n_q):
        qc = qh[:, i * c:(i + 1) * c].float()
        pos_c = q_pos[:, i * c:(i + 1) * c]
        kc = kpad[:, i * c:i * c + band].float()
        vc = vpad[:, i * c:i * c + band]
        k_pos = i * c - (band - c) + torch.arange(band, dtype=torch.int32,
                                                  device=dev)
        s = torch.einsum("bqkgd,bckd->bqkgc", qc, kc) * scale
        kpb = k_pos[None, None, :]
        mask = (kpb <= pos_c[:, :, None]) & \
               (kpb > pos_c[:, :, None] - window) & (kpb >= 0)
        s = torch.where(mask[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bqkgc,bckd->bqkgd", p.to(vc.dtype).float(),
                         vc.float())
        outs.append((o / torch.clamp_min(p.sum(-1)[..., None], 1e-37))
                    .to(k.dtype))
    out = torch.cat(outs, dim=1)
    return out[:, :sq].reshape(b, sq, kh * g, dh)


# ---------------------------------------------------------------------------
# Attention block: projections + RoPE + cache management
# ---------------------------------------------------------------------------


def attention_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                    kind: str,
                    positions: torch.Tensor | int = 0,
                    cache: dict | None = None,
                    cache_index: torch.Tensor | None = None,
                    dist: Any = None,
                    pages: torch.Tensor | None = None,
                    shard: Any = None
                    ) -> tuple[torch.Tensor, dict | None]:
    """Projections + RoPE + attention (+ KV-cache update for decode).

    ``cache``: {"k": (B, S_cache, K, Dh), "v": ...}. If ``S_cache == window``
    for a local layer, the cache is a **ring buffer**. A paged cache holds
    {"pool_k": (P, page_size, K, Dh), "pool_v": ...} and requires
    ``pages``: the (B, pages_per_slot) int32 page table (-1 = unbound; page
    0 is the allocator's trash page). ``cache_index``: int32, scalar or
    (B,) per slot — count of tokens already cached. The cache tensors are
    updated in place and returned in a dict.

    ``dist``: as in the reference, the whole-sequence path does not read
    it: under a :class:`repro_torch.sharding.DistContext` the block runs
    on the rank's local batch shard, and the kernel launches there.
    ``shard``: the cache inside a sharded block's region
    (:class:`repro_torch.sharding.context.CacheShard`): ``cache`` holds the
    rank's local shards. A cache cut over ``model`` on its KV heads is
    attended locally (the rank's heads) as on one device: there is nothing
    to merge. One cut on its sequence is written only where the rank holds
    the rows, and attended either by the sequence-parallel island
    (``DistContext.decode_attention``) under ``flash_decode`` for one new
    token and no ring, as the reference dispatches
    (``repro/models/attention.py:296-303``), or gathered whole and then
    attended as on one device.
    """
    b, s, _ = x.shape
    dt = x.dtype
    dev = x.device
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if cfg.use_qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.rms_eps)
        k = rmsnorm(params["k_norm"], k, cfg.rms_eps)
    theta = cfg.rope_theta
    if kind == "attn" and cfg.rope_theta_global is not None:
        theta = cfg.rope_theta_global
    window = cfg.window_size if kind == "local" else None
    if not cfg.encoder_only:
        pos = _expand_positions(positions, b, s, dev)
        cos, sin = rope_angles(pos, cfg.head_dim, theta)  # shared by q, k
        q = rotate(q, cos, sin)
        k = rotate(k, cos, sin)

    if cache is None:
        # whole sequence (training, encoder-only): the flash-attention
        # kernel on the card; on the CPU its plain version, which is
        # chunked_attention with these arguments
        out = flash_attention(q, k, v, causal=not cfg.encoder_only,
                              window=window, kv_chunk=cfg.kv_chunk,
                              score_dtype=torch_dtype(cfg.score_dtype))
        y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
        return y, None

    assert cache_index is not None
    start = cache_index         # a Python int where the caller has one
    cache_index = torch.as_tensor(cache_index, dtype=torch.int32, device=dev)
    per_slot = cache_index.dim() == 1  # continuous batching: (B,) positions

    if "pool_k" in cache:  # paged KV cache (serving tier)
        assert per_slot and s == 1 and pages is not None
        out = _paged_decode(cfg, q, k, v, cache, cache_index, pages, window)
        y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
        return y, cache

    ck, cv = cache["k"], cache["v"]
    # a sequence-sharded cache: this rank's rows [r0, r0 + n) of s_cache
    r0, s_cache = shard.rows if shard is not None else (0, ck.shape[1])
    n = ck.shape[1]
    is_ring = window is not None and s_cache == window
    cdt = ck.dtype
    if is_ring:
        # ring write: token at absolute position p lands in row p % window.
        take = min(s, window)
        steps = torch.arange(s - take, s, dtype=torch.int32, device=dev)
        if per_slot:
            slots = ((cache_index[:, None] + steps[None, :]) % window).long()
            t_new = (cache_index + s)[:, None]                  # (B, 1)
        else:
            slots = ((cache_index + steps) % window).long()
            t_new = (cache_index + s).reshape(1, 1).expand(b, 1)
        _store(ck, cv, k[:, s - take:], v[:, s - take:], slots, per_slot,
               r0, n == s_cache)
        # row j holds position t_new - 1 - ((t_new - 1 - j) mod window).
        j = torch.arange(window, dtype=torch.int32, device=dev)[None, :]
        k_positions = t_new - 1 - torch.remainder(t_new - 1 - j, window)
        k_valid = k_positions >= 0
    else:
        if per_slot:
            slots = (cache_index[:, None] +
                     torch.arange(s, dtype=torch.int32, device=dev)).long()
            _store(ck, cv, k, v, slots, True, r0, n == s_cache)
            end = (cache_index + s)[:, None]
        else:
            start = start if isinstance(start, int) else int(cache_index)
            lo, hi = max(start, r0), min(start + s, r0 + n)
            if lo < hi:          # the rows of [start, start + s) held here
                ck[:, lo - r0:hi - r0] = k[:, lo - start:hi - start].to(cdt)
                cv[:, lo - r0:hi - r0] = v[:, lo - start:hi - start].to(cdt)
            end = (cache_index + s).reshape(1, 1).expand(b, 1)
        k_positions = torch.arange(s_cache, dtype=torch.int32,
                                   device=dev).expand(b, s_cache)
        k_valid = k_positions < end
    if (shard is not None and shard.seq is not None
            and shard.has("flash_decode") and s == 1 and not is_ring):
        # sequence-parallel decode: each rank its slice, partial softmax
        # statistics merged over `model`
        out = shard.dist.decode_attention(
            q, ck.to(dt), cv.to(dt), k_positions[:, r0:r0 + n],
            k_valid[:, r0:r0 + n], window=window, kv_chunk=cfg.kv_chunk,
            q_offset=positions)
    else:
        if shard is not None:   # the reference's baseline: gathered whole
            ck, cv = shard.gather(ck, cv)
        if cfg.decode_kernel == "flash" and s == 1 and per_slot:
            # serving hot path: the flash-decode kernel. The -1-invalid
            # position encoding folds k_valid into k_positions; ring caches
            # (row != position) disable the occupancy bound.
            from repro_torch.kernels.flash_decode import decode_attention
            out = decode_attention(
                q, ck.to(dt), cv.to(dt), cache_index,
                torch.where(k_valid, k_positions, -1), window=window,
                bounded=not is_ring)
        else:
            out = chunked_attention(q, ck.to(dt), cv.to(dt),
                                    q_offset=positions,
                                    k_positions=k_positions, causal=True,
                                    window=window, kv_chunk=cfg.kv_chunk,
                                    k_valid=k_valid)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return y, cache


def _store(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, slots: torch.Tensor, per_slot: bool, r0: int,
           whole: bool) -> None:
    """Write k/v (B, T, K, D) into cache rows ``slots`` ((B, T) per slot,
    else (T,) for every slot, global rows). ``whole``: the caches hold every
    row; else they hold rows [r0, r0 + ck.shape[1]) of a sequence-sharded
    cache and only the slots there are written."""
    if whole:
        if per_slot:
            rows = torch.arange(ck.shape[0], device=ck.device)[:, None]
            ck[rows, slots] = k.to(ck.dtype)
            cv[rows, slots] = v.to(cv.dtype)
        else:
            ck[:, slots] = k.to(ck.dtype)
            cv[:, slots] = v.to(cv.dtype)
        return
    from repro_torch.sharding.context import write_rows
    if not per_slot:
        slots = slots[None, :].expand(ck.shape[0], -1)
    write_rows(ck, slots, k, r0)
    write_rows(cv, slots, v, r0)


def _paged_decode(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, cache: dict, positions: torch.Tensor,
                  pages: torch.Tensor, window: int | None) -> torch.Tensor:
    """One decode step against a paged KV cache.

    The new token is stored into its slot's current page (slots whose table
    row is unbound clamp to the reserved trash page 0), then attention
    reads through the page table. ``decode_kernel="flash"`` uses the paged
    kernel; "chunked" gathers the logical view and runs the reference path
    — pages are bound in logical order, so offsets past a slot's position
    hold garbage but are causally masked (``k_pos > q_pos``).
    """
    b = q.shape[0]
    dt = q.dtype
    ck, cv = cache["pool_k"], cache["pool_v"]
    cdt = ck.dtype
    page_size = ck.shape[1]
    dev = q.device
    pages = torch.as_tensor(pages, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    page = torch.clamp_min(pages[rows, (positions // page_size).long()], 0)
    off = (positions % page_size).long()
    ck[page.long(), off] = k[:, 0].to(cdt)
    cv[page.long(), off] = v[:, 0].to(cdt)
    if cfg.decode_kernel == "flash":
        from repro_torch.kernels.flash_decode import decode_attention_paged
        return decode_attention_paged(q, ck.to(dt), cv.to(dt), positions,
                                      pages, window=window)
    n_pages = pages.shape[1]
    tbl = torch.clamp_min(pages, 0).long()
    kh, dk = ck.shape[2], ck.shape[3]
    dv = cv.shape[3]
    k_lin = ck[tbl].reshape(b, n_pages * page_size, kh, dk)
    v_lin = cv[tbl].reshape(b, n_pages * page_size, kh, dv)
    kp = (torch.arange(n_pages, dtype=torch.int32, device=dev)[:, None]
          * page_size
          + torch.arange(page_size, dtype=torch.int32, device=dev)[None, :])
    kp = torch.where(pages[:, :, None] >= 0, kp[None],
                     torch.tensor(-1, dtype=torch.int32, device=dev))
    kp = kp.reshape(b, n_pages * page_size)
    return chunked_attention(q, k_lin.to(dt), v_lin.to(dt),
                             q_offset=positions, k_positions=kp,
                             causal=True, window=window,
                             kv_chunk=cfg.kv_chunk, k_valid=kp >= 0,
                             score_dtype=torch_dtype(cfg.score_dtype))


def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  dtype: torch.dtype, device: str | torch.device) -> dict:
    """Per-layer KV cache. Local layers get a ring buffer of size ``window``
    (when max_len exceeds it)."""
    length = max_len
    if kind == "local":
        length = min(max_len, cfg.window_size)
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
