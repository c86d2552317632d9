"""Mamba-2 SSD — state-space duality block (arXiv:2405.21060).

Port of ``repro/models/ssd.py``. The selective state space recurrence

    h_t = exp(dt_t · A) h_{t-1} + dt_t · B_t x_tᵀ        (state: (H, P, N))
    y_t = C_t h_t + D ⊙ x_t

is computed in the paper's chunked block decomposition by
:func:`repro_torch.kernels.ssd.ssd_scan`: the hand-written CUDA kernel for
a CUDA tensor (its gradient through the plain version), the plain PyTorch
version for a CPU tensor. Decode is the O(1) recurrence :func:`ssd_step`.

Differences from the reference, both deliberate:

* the scan masks its exponent before ``exp`` (the reference takes ``exp``
  over the whole chunk square, which overflows above the diagonal and
  turns the backward into NaN at full width): forward values are equal,
  gradients equal wherever the reference's are finite;
* with a cache, :func:`ssd_block` writes the new state and conv window into
  the cache tensors in place and returns the same dict (the port's decode
  caches are written in place).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd_scan

from .config import ModelConfig
from .params import ParamSpec


def ssd_spec(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = cfg.ssd_inner
    nh = cfg.ssd_heads
    n = s.d_state
    return {
        # in_proj: [z (di), x (di), B (n), C (n), dt (nh)]  (n_groups = 1)
        "w_in": ParamSpec((d, 2 * di + 2 * n + nh), ("embed", "ff"),
                          init="lecun"),
        "conv_w": ParamSpec((s.d_conv, di + 2 * n), ("conv", "ff"),
                            init="lecun"),
        "conv_b": ParamSpec((di + 2 * n,), ("ff",), init="zeros"),
        "a_log": ParamSpec((nh,), ("heads",), init="a_log"),
        "dt_bias": ParamSpec((nh,), ("heads",), init="dt_bias"),
        "d_skip": ParamSpec((nh,), ("heads",), init="ones"),
        "norm": {"scale": ParamSpec((di,), ("ff",), init="ones")},
        "w_out": ParamSpec((di, d), ("ff", "embed"), init="lecun"),
    }


def _split_in(cfg: ModelConfig, proj: torch.Tensor):
    di = cfg.ssd_inner
    n = cfg.ssm.d_state
    nh = cfg.ssd_heads
    return torch.split(proj, [di, di, n, n, nh], dim=-1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: (B,S,H,P); dt: (B,S,H) (post-softplus); a: (H,)
    negative; bmat/cmat: (B,S,N) (single group). Returns (y (B,S,H,P),
    h (B,H,P,N) float32)."""
    return ssd_scan(x, dt, a, bmat, cmat, chunk=chunk, h0=h0)


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, hprev: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode: x (B,1,H,P), dt (B,1,H), b/c (B,1,N), h (B,H,P,N)."""
    dtf = dt[:, 0].float()                               # (B,H)
    decay = torch.exp(dtf * a[None, :])                  # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dtf, bmat[:, 0].float(),
                       x[:, 0].float())
    h = decay[:, :, None, None] * hprev + upd
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), h)
    return y[:, None].to(x.dtype), h


def _rmsnorm_gated(scale: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   eps: float) -> torch.Tensor:
    xf = (x * F.silu(z)).float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def ssd_block(params: dict, cfg: ModelConfig, x_in: torch.Tensor, *,
              cache: dict | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """Full Mamba-2 block. x_in: (B, S, d).
    ``cache``: {"h": (B,H,P,N) f32, "conv": (B, d_conv-1, di+2N)}, updated
    in place and returned."""
    s_cfg = cfg.ssm
    b, s, _ = x_in.shape
    dt_ = x_in.dtype
    di = cfg.ssd_inner
    nh = cfg.ssd_heads
    p = s_cfg.head_dim
    proj = x_in @ params["w_in"].to(dt_)
    z, xbc_x, bmat, cmat, dtp = _split_in(cfg, proj)
    # conv over concat(x, B, C)
    xbc = torch.cat([xbc_x, bmat, cmat], dim=-1)
    k = s_cfg.d_conv
    if cache is not None:
        conv_state = cache["conv"]
    else:
        conv_state = torch.zeros((b, k - 1, xbc.shape[-1]), dtype=dt_,
                                 device=x_in.device)
    ext = torch.cat([conv_state, xbc], dim=1)
    conv_w = params["conv_w"].to(dt_)
    acc = ext[:, 0:s] * conv_w[0]
    for i in range(1, k):
        acc = acc + ext[:, i:i + s] * conv_w[i]
    xbc = F.silu(acc + params["conv_b"].to(dt_))
    new_conv = ext[:, -(k - 1):] if k > 1 else conv_state
    xs, bmat, cmat = torch.split(xbc, [di, s_cfg.d_state, s_cfg.d_state],
                                 dim=-1)
    xh = xs.reshape(b, s, nh, p)
    dt_soft = F.softplus(dtp.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    if cache is not None and s == 1:
        y, h_new = ssd_step(xh, dt_soft, a, bmat, cmat, cache["h"])
    else:
        h0 = cache["h"] if cache is not None else None
        y, h_new = ssd_chunked(xh, dt_soft, a, bmat, cmat,
                               chunk=s_cfg.chunk_size, h0=h0)
    y = y + params["d_skip"].to(dt_)[None, None, :, None] * xh
    y = y.reshape(b, s, di)
    y = _rmsnorm_gated(params["norm"]["scale"], y, z, cfg.rms_eps)
    out = y @ params["w_out"].to(dt_)
    if cache is not None:
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
    return out, cache


def init_ssd_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: str | torch.device = "cuda") -> dict:
    s = cfg.ssm
    return {
        "h": torch.zeros((batch, cfg.ssd_heads, s.head_dim, s.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1,
                             cfg.ssd_inner + 2 * s.d_state),
                            dtype=dtype, device=device),
    }
