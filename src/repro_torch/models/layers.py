"""Shared layers: RMSNorm, RoPE, gated MLPs, embeddings.

Port of ``repro/models/layers.py``: pure functions over explicit parameter
dicts declared with :class:`~repro_torch.models.params.ParamSpec`. The
numerics follow the reference: RMSNorm in float32, RoPE on split halves
(not interleaved), the tanh GELU, the embedding scale rounded to the
working dtype, logits in ``logit_dtype``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamSpec


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


# -- RMSNorm -----------------------------------------------------------------

def rmsnorm_spec(dim: int) -> dict:
    return {"scale": ParamSpec((dim,), ("embed",), init="ones")}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


# -- RoPE ---------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


@functools.lru_cache(maxsize=32)
def _frequencies(head_dim: int, theta: float,
                 device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies`, computed once per (head_dim, theta, device):
    the decode step would otherwise rebuild it for q and k in every layer."""
    return rope_frequencies(head_dim, theta, device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles, shaped to broadcast over
    (B, S, H, D/2); positions: (S,) or (B, S)."""
    freqs = _frequencies(head_dim, theta, positions.device)    # (D/2,)
    ang = positions[..., None].float() * freqs                 # (.., S, D/2)
    if positions.dim() == 1:
        ang = ang[None, :, None, :]                            # (1, S, 1, D/2)
    else:
        ang = ang[:, :, None, :]                               # (B, S, 1, D/2)
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """RoPE (the reference's ``apply_rope``) on x: (B, S, H, D), split
    halves (not interleaved), in float32, with the angles of
    :func:`rope_angles` — computed once per layer for q and k."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- MLP ------------------------------------------------------------------------

def mlp_spec(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": ParamSpec((d, f), ("embed", "ff"), init="lecun"),
            "w_up": ParamSpec((d, f), ("embed", "ff"), init="lecun"),
            "w_down": ParamSpec((f, d), ("ff", "embed"), init="lecun"),
        }
    return {  # plain gelu MLP (hubert)
        "w_up": ParamSpec((d, f), ("embed", "ff"), init="lecun"),
        "w_down": ParamSpec((f, d), ("ff", "embed"), init="lecun"),
    }


def _gelu_tanh(u: torch.Tensor) -> torch.Tensor:
    return F.gelu(u, approximate="tanh")


def mlp(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else _gelu_tanh
        g = act(x @ params["w_gate"])
        u = x @ params["w_up"]
        return (g * u) @ params["w_down"]
    h = _gelu_tanh(x @ params["w_up"])
    return h @ params["w_down"]


# -- Embedding / head ---------------------------------------------------------------

def embedding_spec(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab
    d = {"embedding": ParamSpec((v, cfg.d_model),
                                ("vocab", "embed"), init="normal", scale=0.02)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamSpec((cfg.d_model, v),
                                 ("embed", "vocab"), init="lecun")
    return d


def embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # .to() of a tensor already in the dtype returns it: no per-step copy
    x = params["embedding"].to(torch_dtype(cfg.dtype))[tokens.long()]
    if cfg.scale_embeddings:
        # the scale is rounded to the working dtype first, as in the reference
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, padded_vocab) logits in ``logit_dtype``.

    The reference asks for the product's own output in ``logit_dtype``
    (``preferred_element_type``): with bf16 weights the sums are kept in
    float32 and never rounded to bf16. A bf16 ``torch.matmul`` would round
    its output to bf16 before any cast, and upcasting the weights would copy
    the (tied, 262144 x 1152 at gemma3-1b) table every step. So for a
    narrower working dtype on the card the port takes ``torch.mm`` with
    ``out_dtype`` (bf16 inputs, float32 accumulation and output, the weights
    read in place); float32 weights need nothing but the plain product. On
    the CPU, where ``out_dtype`` has no kernel, a narrower dtype upcasts.
    """
    if cfg.tie_embeddings:
        w = params["embedding"].to(x.dtype).T
    else:
        w = params["unembed"]
    out_dt = torch_dtype(cfg.logit_dtype)
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if x.dtype == out_dt and w.dtype == out_dt:
        logits = x2 @ w
    elif x.device.type == "cuda":
        logits = torch.mm(x2, w, out_dtype=out_dt)
    else:
        logits = x2.to(out_dt) @ w.to(out_dt)
    return logits.reshape(b, s, -1)
