"""Plain reference of a Mamba-2 language model (arXiv:2405.21060), from the
sizes of its configuration file.

Each layer: x + Mamba2(RMSNorm(x)), where Mamba2 is the published block
with one group: in_proj to [z, x, B, C, dt]; a causal depthwise conv of
width ``d_conv`` with bias over [x, B, C], then SiLU; dt = softplus(dt +
dt_bias); A = -exp(A_log); the SSD scan; y + D x; RMSNorm(y * SiLU(z)) (the
gated norm, normalised after the gate); out_proj. Then a final RMSNorm and
the tied unembedding over the vocabulary padded to
``pad_vocab_size_multiple`` rows. No bias in the projections.

The weight tree keeps each layer's leaves stacked on a leading axis of
``n_layer``, the layout in which the benchmark hands the same weights to
the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .common import FULL, Leaf, Precision, lm_loss, rmsnorm, ssd_scan


def sizes(spec: dict) -> dict:
    d = spec["d_model"]
    di = spec["expand"] * d
    mult = spec["pad_vocab_size_multiple"]
    return {"d": d, "di": di, "n": spec["d_state"], "p": spec["headdim"],
            "h": di // spec["headdim"], "k": spec["d_conv"],
            "L": spec["n_layer"],
            "v_pad": -(-spec["vocab_size"] // mult) * mult,
            "chunk": spec["chunk_size"], "eps": spec["norm_epsilon"]}


def weight_leaves(spec: dict) -> list[Leaf]:
    z = sizes(spec)
    d, di, n, h, L = z["d"], z["di"], z["n"], z["h"], z["L"]
    conv = di + 2 * n
    mix = ("periods", "0", "mix")
    return [
        Leaf(("embed", "embedding"), (z["v_pad"], d), "normal", 0.02),
        Leaf(("final_norm", "scale"), (d,), "ones"),
        Leaf(("periods", "0", "norm1", "scale"), (L, d), "ones"),
        Leaf(mix + ("w_in",), (L, d, 2 * di + 2 * n + h), "normal",
             1 / math.sqrt(d)),
        Leaf(mix + ("conv_w",), (L, z["k"], conv), "normal",
             1 / math.sqrt(z["k"])),
        Leaf(mix + ("conv_b",), (L, conv), "zeros"),
        Leaf(mix + ("a_log",), (L, h), "a_log"),
        Leaf(mix + ("dt_bias",), (L, h), "dt_bias"),
        Leaf(mix + ("d_skip",), (L, h), "ones"),
        Leaf(mix + ("norm", "scale"), (L, di), "ones"),
        Leaf(mix + ("w_out",), (L, di, d), "normal", 1 / math.sqrt(di)),
    ]


def _layer(x: torch.Tensor, w: dict, i: int, z: dict, prec: Precision
           ) -> torch.Tensor:
    mix = w["periods"]["0"]["mix"]
    b, s, _ = x.shape
    di, n, h, p, k = z["di"], z["n"], z["h"], z["p"], z["k"]
    hn = rmsnorm(x, w["periods"]["0"]["norm1"]["scale"][i], z["eps"])
    proj = prec.q(hn) @ prec.q(mix["w_in"][i])
    zg, xbc, dtp = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    ext = F.pad(xbc, (0, 0, k - 1, 0))              # causal, zero history
    conv_w = mix["conv_w"][i]
    acc = sum(ext[:, j:j + s] * conv_w[j] for j in range(k))
    xbc = F.silu(acc + mix["conv_b"][i])
    xs, bm, cm = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dtp + mix["dt_bias"][i])
    a = -torch.exp(mix["a_log"][i])
    xh = xs.reshape(b, s, h, p)
    y = ssd_scan(xh, dt, a, bm, cm, chunk=z["chunk"], prec=prec)
    y = (y + mix["d_skip"][i][:, None] * xh).reshape(b, s, di)
    y = rmsnorm(y * F.silu(zg), mix["norm"]["scale"][i], z["eps"])
    return x + prec.q(y) @ prec.q(mix["w_out"][i])


def hidden(w: dict, spec: dict, tokens: torch.Tensor,
           prec: Precision = FULL) -> torch.Tensor:
    """Final-normed hidden states (B, S, d); each layer checkpointed when
    gradients are on, so that a full-size sequence fits."""
    z = sizes(spec)
    x = w["embed"]["embedding"][tokens.long()]
    for i in range(z["L"]):
        if torch.is_grad_enabled():
            x = checkpoint(_layer, x, w, i, z, prec, use_reentrant=False)
        else:
            x = _layer(x, w, i, z, prec)
    return rmsnorm(x, w["final_norm"]["scale"], z["eps"])


def loss(w: dict, spec: dict, batch: dict, z_weight: float,
         prec: Precision = FULL) -> torch.Tensor:
    h = hidden(w, spec, batch["tokens"], prec)
    logits = prec.q(h) @ prec.q(w["embed"]["embedding"]).T
    return lm_loss(logits, batch["labels"], z_weight)


def model_ops(spec: dict, batch: int, seq: int, train: bool) -> float:
    """Operations of the model's weight products over ``batch`` x ``seq``
    positions, 2 a weight a position forward and 6 for a training step:
    in_proj, the depthwise conv, out_proj and the tied unembedding (the
    embedding lookup is no product). The SSD scan's own products are not
    counted (its work depends on the algorithm; its kernel has a roofline
    of its own)."""
    z = sizes(spec)
    d, di, n, h = z["d"], z["di"], z["n"], z["h"]
    per_layer = d * (2 * di + 2 * n + h) + z["k"] * (di + 2 * n) + di * d
    weights = z["L"] * per_layer + z["v_pad"] * d
    return float((6 if train else 2) * weights * batch * seq)


def ssd_shape(spec: dict, batch: int, seq: int) -> tuple[int, ...]:
    """(B, S, H, P, N) of one layer's scan."""
    z = sizes(spec)
    return batch, seq, z["h"], z["p"], z["n"]


def inputs(spec: dict) -> dict:
    """What a row of traffic holds: token ids of the vocabulary."""
    return {"kind": "tokens", "vocab": spec["vocab_size"]}
