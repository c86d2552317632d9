"""Multi-head Latent Attention (DeepSeek-V3, arXiv:2412.19437).

Port of ``repro/models/mla.py``. Queries go through a LoRA bottleneck
(``q_lora_rank``); keys/values are compressed into a small latent
(``kv_lora_rank``) plus one shared RoPE head. The whole-sequence forward
(training, prefill without a cache) materializes per-head K/V; decode uses
the **absorbed** formulation — attention runs directly in the compressed
latent, so the KV cache is ``kv_lora_rank + rope_head_dim`` values per
token in total (not per head).

Both paths call :func:`repro_torch.models.attention.chunked_attention`, as
the reference does on one device: the materialized path has a key width
(nope + rope) other than its value width, the absorbed one attends over
the latent (R + rope keys, R values), and no Pallas kernel backs either in
the reference. They stay plain PyTorch on the card.

Sharded decode (inside a sharded block's region, ``shard`` the latent
cache's :class:`repro_torch.sharding.context.CacheShard`): the latent
cache's sequence is cut over ``model``; a rank writes the new token's row
only where it holds that row. Under ``flash_decode`` one new token takes
the sequence-parallel island (``repro/models/mla.py:123-130``), whose local
attention is ``chunked_attention`` with statistics on every device: MLA's
128 query heads on its one latent head (keys of R + rope = 576) are beyond
the flash-decode kernel (G <= 16, head dims <= 256), so this module asks
the island for it (``kernel=False``), as the single-device decode takes
it. Otherwise the cache is gathered whole over ``model`` for the
attention.

Caches are written in place: the new token's latent and RoPE key are
stored into the cache tensors, and the returned dict holds the same
tensors.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from .attention import _expand_positions, chunked_attention
from .config import ModelConfig
from .layers import rmsnorm, rope_angles, rotate, torch_dtype
from .params import ParamSpec


def mla_spec(cfg: ModelConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "w_dq": ParamSpec((d, m.q_lora_rank), ("embed", "lora"), init="lecun"),
        "q_norm": {"scale": ParamSpec((m.q_lora_rank,), (None,), init="ones")},
        "w_uq": ParamSpec((m.q_lora_rank, h, qk), ("lora", "heads", "head_dim"),
                          init="lecun"),
        "w_dkv": ParamSpec((d, m.kv_lora_rank + m.rope_head_dim),
                           ("embed", "lora"), init="lecun"),
        "kv_norm": {"scale": ParamSpec((m.kv_lora_rank,), (None,),
                                       init="ones")},
        "w_uk": ParamSpec((m.kv_lora_rank, h, m.nope_head_dim),
                          ("lora", "heads", "head_dim"), init="lecun"),
        "w_uv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                          ("lora", "heads", "head_dim"), init="lecun"),
        "w_o": ParamSpec((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                         init="lecun"),
    }


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float
          ) -> torch.Tensor:
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    return rotate(x, cos, sin)


def _project_q(params: dict, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q_nope (B,S,H,nope), q_rope (B,S,H,rope))."""
    m = cfg.mla
    cq = rmsnorm(params["q_norm"], x @ params["w_dq"], cfg.rms_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"])
    q_nope, q_rope = torch.split(q, [m.nope_head_dim, m.rope_head_dim],
                                 dim=-1)
    return q_nope, _rope(q_rope, positions, cfg.rope_theta)


def _compress_kv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (c_kv (B,S,R), k_rope (B,S,1,rope)) — exactly what the cache
    holds."""
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    c_kv, k_rope = torch.split(dkv, [m.kv_lora_rank, m.rope_head_dim],
                               dim=-1)
    c_kv = rmsnorm(params["kv_norm"], c_kv, cfg.rms_eps)
    return c_kv, _rope(k_rope[:, :, None, :], positions, cfg.rope_theta)


def mla_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
              positions: torch.Tensor | int = 0,
              cache: dict | None = None,
              cache_index: torch.Tensor | None = None,
              dist: Any = None, shard: Any = None
              ) -> tuple[torch.Tensor, dict | None]:
    """MLA attention block. ``cache``: {"c_kv": (B, S, R), "k_rope": (B, S,
    rope)}, written in place and returned; ``cache_index``: int32, scalar
    or (B,) per slot. ``dist``: the whole-sequence path does not read it
    (the sharded block runs on the rank's local batch shard). ``shard``:
    the cache as a sharded region holds it (see the module's note)."""
    m = cfg.mla
    b, s, _ = x.shape
    dt = x.dtype
    dev = x.device
    pos = _expand_positions(positions if cache is not None else 0, b, s, dev)
    q_nope, q_rope = _project_q(params, cfg, x, pos)
    c_kv, k_rope = _compress_kv(params, cfg, x, pos)
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)

    if cache is None:
        # materialized path (training / whole-sequence prefill)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uk"])
        v = torch.einsum("bsr,rhk->bshk", c_kv, params["w_uv"])
        k = torch.cat([k_nope, k_rope.expand(b, s, cfg.n_heads,
                                             m.rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = chunked_attention(q, k, v, causal=True, kv_chunk=cfg.kv_chunk,
                                scale=scale,
                                score_dtype=torch_dtype(cfg.score_dtype))
        y = torch.einsum("bshk,hkd->bsd", out, params["w_o"].to(dt))
        return y, None

    # absorbed decode: attention in the compressed latent
    assert cache_index is not None
    cache_index = torch.as_tensor(cache_index, dtype=torch.int32, device=dev)
    ck, cr = cache["c_kv"], cache["k_rope"]
    cdt = ck.dtype
    # a scalar index is every slot's; (B,) per slot under continuous batching
    cache_index = cache_index.expand(b)
    slots = (cache_index[:, None] +
             torch.arange(s, dtype=torch.int32, device=dev)).long()
    r0, s_cache = shard.rows if shard is not None else (0, ck.shape[1])
    n = ck.shape[1]
    if n == s_cache:
        rows = torch.arange(b, device=dev)[:, None]
        ck[rows, slots] = c_kv.to(cdt)
        cr[rows, slots] = k_rope[:, :, 0, :].to(cdt)
    else:             # this rank's rows [r0, r0 + n) of the sequence
        from repro_torch.sharding.context import write_rows
        write_rows(ck, slots, c_kv, r0)
        write_rows(cr, slots, k_rope[:, :, 0, :], r0)
    end = (cache_index + s)[:, None]
    # q_eff[h] = q_nope[h] @ w_uk[h]^T: the query against c_kv directly
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, params["w_uk"].to(dt))
    q_cat = torch.cat([q_eff, q_rope], dim=-1)                # (B,S,H,R+rope)
    k_positions = torch.arange(s_cache, dtype=torch.int32,
                               device=dev).expand(b, s_cache)
    k_valid = k_positions < end
    if (shard is not None and shard.seq is not None
            and shard.has("flash_decode") and s == 1):
        # sequence-parallel decode over this rank's latent rows; the local
        # attention is chunked_attention on every device (G = 128 query
        # heads on the latent head: past the flash-decode kernel)
        k_cat = torch.cat([ck, cr], dim=-1)[:, :, None, :]
        ctx = shard.dist.decode_attention(
            q_cat.to(dt), k_cat.to(dt), ck[:, :, None, :].to(dt),
            k_positions[:, r0:r0 + n], k_valid[:, r0:r0 + n],
            kv_chunk=cfg.kv_chunk, q_offset=positions, scale=scale,
            kernel=False)
    else:
        if shard is not None:    # the reference's baseline: gathered whole
            ck, cr = shard.gather(ck, cr)
        k_cat = torch.cat([ck, cr], dim=-1)[:, :, None, :]    # (B,Sc,1,R+rope)
        v_lat = ck[:, :, None, :]                             # (B,Sc,1,R)
        ctx = chunked_attention(q_cat.to(dt), k_cat.to(dt), v_lat.to(dt),
                                q_offset=positions, causal=True,
                                kv_chunk=cfg.kv_chunk, k_valid=k_valid,
                                scale=scale)                  # (B,S,H,R)
    # absorb the value up-projection, then the output projection
    ctx = torch.einsum("bshr,rhk->bshk", ctx, params["w_uv"].to(dt))
    y = torch.einsum("bshk,hkd->bsd", ctx, params["w_o"].to(dt))
    return y, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype,
                   device: str | torch.device = "cuda") -> dict:
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.rope_head_dim), dtype=dtype,
                              device=device),
    }
