"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro/models/rglru.py``. The recurrence is a gated linear RNN:

    r_t = sigmoid(W_a u_t)                 (recurrence gate)
    i_t = sigmoid(W_x u_t)                 (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t)

computed over chunks: a sequential loop across chunks carrying ``h``, and
inside a chunk a log-depth scan of the pairs ``(a_t, x_t)`` under the same
combine as the reference's ``associative_scan`` (a Hillis-Steele scan: the
sums are grouped in another tree, so values agree within float32
rounding). Decode is the O(1) single-step update; the layer's cache is
``(h, conv_state)`` whatever the context length.

The reference has no Pallas kernel here, so the port stays plain PyTorch on
the card too. With a cache, :func:`rglru_block` writes the new state and
conv window into the cache tensors in place and returns the same dict (the
port's decode caches are written in place; the reference returns new
arrays).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig, RGLRUConfig
from .params import ParamSpec


def rglru_spec(cfg: ModelConfig) -> dict:
    r = cfg.rglru or RGLRUConfig()
    d = cfg.d_model
    w = r.lru_width or d
    return {
        "w_x": ParamSpec((d, w), ("embed", "ff"), init="lecun"),
        "w_gate_branch": ParamSpec((d, w), ("embed", "ff"), init="lecun"),
        "conv_w": ParamSpec((r.conv_width, w), ("conv", "ff"), init="lecun"),
        "conv_b": ParamSpec((w,), ("ff",), init="zeros"),
        "w_a": ParamSpec((w, w), ("ff", None), init="lecun"),
        "w_i": ParamSpec((w, w), ("ff", None), init="lecun"),
        "lam": ParamSpec((w,), ("ff",), init="lambda_rglru"),
        "w_out": ParamSpec((w, d), ("ff", "embed"), init="lecun"),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. u: (B, S, W); w: (K, W); state: (B, K-1, W).
    Returns (out, new_state)."""
    k = w.shape[0]
    s = u.shape[1]
    if state is None:
        state = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([state, u], dim=1)                  # (B, K-1+S, W)
    out = ext[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + s] * w[i]
    out = out + b
    new_state = ext[:, -(k - 1):] if k > 1 else state
    return out.to(u.dtype), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x), with no linear cut-off (F.softplus
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gates(params: dict, cfg: ModelConfig, u: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (a, gated input), both (..., W) float32."""
    r = cfg.rglru or RGLRUConfig()
    rt = torch.sigmoid(u @ params["w_a"].to(u.dtype)).float()
    it = torch.sigmoid(u @ params["w_i"].to(u.dtype)).float()
    log_a = -r.c * _softplus(params["lam"].float()) * rt
    a = torch.exp(log_a)
    x_in = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (it * u.float())
    return a, x_in


def _scan_chunk(a: torch.Tensor, x: torch.Tensor, h: torch.Tensor
                ) -> torch.Tensor:
    """h_t = a_t h_{t-1} + x_t over the chunk's steps (axis 1) from ``h``
    (B, W): the inclusive scan of (a, x) under (p, q) -> (p_a q_a, q_a p_x
    + q_x) in ceil(log2(steps)) rounds, then h_t = A_t h + X_t."""
    aa, bb = a, x
    d = 1
    while d < a.shape[1]:
        bb = torch.cat([bb[:, :d], aa[:, d:] * bb[:, :-d] + bb[:, d:]], dim=1)
        aa = torch.cat([aa[:, :d], aa[:, d:] * aa[:, :-d]], dim=1)
        d *= 2
    return aa * h[:, None] + bb


def rglru_scan(params: dict, cfg: ModelConfig, u: torch.Tensor, *,
               h0: torch.Tensor | None = None, chunk: int = 512
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """u: (B, S, W) -> (h_seq (B, S, W) in u.dtype, h_final (B, W) f32)."""
    b, s, w = u.shape
    a, x_in = _gates(params, cfg, u)
    h = torch.zeros((b, w), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    c = min(chunk, s)
    n = -(-s // c)
    pad = n * c - s
    if pad:
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        x_in = F.pad(x_in, (0, 0, 0, pad))
    chunks = []
    for i in range(n):
        hs = _scan_chunk(a[:, i * c:(i + 1) * c], x_in[:, i * c:(i + 1) * c],
                         h)
        h = hs[:, -1]
        chunks.append(hs)
    hs = torch.cat(chunks, dim=1)[:, :s]
    return hs.to(u.dtype), h


def rglru_step(params: dict, cfg: ModelConfig, u: torch.Tensor,
               h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode: u (B, 1, W), h (B, W) f32 -> (out (B, 1, W), h_new)."""
    a, x_in = _gates(params, cfg, u)
    h_new = a[:, 0] * h + x_in[:, 0]
    return h_new[:, None, :].to(u.dtype), h_new


def rglru_block(params: dict, cfg: ModelConfig, x: torch.Tensor, *,
                cache: dict | None = None
                ) -> tuple[torch.Tensor, dict | None]:
    """Full Griffin recurrent block: in-proj → conv → RG-LRU, gated,
    out-proj. x: (B, S, d). ``cache``: {"h": (B, W) f32, "conv": (B, K-1,
    W)}, updated in place and returned."""
    dt = x.dtype
    u = x @ params["w_x"].to(dt)
    gate = F.gelu(x @ params["w_gate_branch"].to(dt), approximate="tanh")
    conv_state = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(u, params["conv_w"].to(dt),
                               params["conv_b"].to(dt), conv_state)
    if cache is not None and x.shape[1] == 1:
        hs, h_new = rglru_step(params, cfg, u, cache["h"])
    else:
        h0 = cache["h"] if cache is not None else None
        hs, h_new = rglru_scan(params, cfg, u, h0=h0)
    y = (hs * gate) @ params["w_out"].to(dt)
    if cache is not None:
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
    return y, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: str | torch.device = "cuda") -> dict:
    r = cfg.rglru or RGLRUConfig()
    w = r.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, r.conv_width - 1, w), dtype=dtype,
                            device=device),
    }
