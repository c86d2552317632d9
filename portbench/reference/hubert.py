"""Plain reference of the encoder the program runs at HuBERT's sizes
(arXiv:2106.07447), from the sizes of its configuration file: the block
below, not HuBERT's published one.

The input is the feature extractor's output: ``conv_dim`` wide frames,
projected linearly (with bias) to ``hidden_size``. Each layer is pre-norm:
x + Attention(RMSNorm(x)), then x + W_down GELU(W_up RMSNorm(x)), with
bidirectional softmax attention of ``num_attention_heads`` heads, no
positional term and no bias in the attention and MLP products; GELU is the
tanh form. A final RMSNorm and an untied linear head over the target units,
padded to ``pad_vocab_size_multiple`` columns. The configuration file lists
under ``reduced`` and ``differences`` where this departs from the published
model.

The weight tree keeps each layer's leaves stacked on a leading axis of
``num_hidden_layers``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .common import FULL, Leaf, Precision, attention, gelu_tanh, lm_loss, \
    rmsnorm


def sizes(spec: dict) -> dict:
    d = spec["hidden_size"]
    h = spec["num_attention_heads"]
    mult = spec["pad_vocab_size_multiple"]
    return {"d": d, "h": h, "dh": d // h, "f": spec["intermediate_size"],
            "L": spec["num_hidden_layers"], "inp": spec["conv_dim"][-1],
            "v_pad": -(-spec["num_target_units"] // mult) * mult,
            "v": spec["num_target_units"], "eps": spec["layer_norm_eps"]}


def weight_leaves(spec: dict) -> list[Leaf]:
    z = sizes(spec)
    d, h, dh, f, L = z["d"], z["h"], z["dh"], z["f"], z["L"]
    per = ("periods", "0")
    lec = 1 / math.sqrt(d)
    return [
        # the token table of the program's layout: an encoder of frames
        # never reads it (its gradient is zero)
        Leaf(("embed", "embedding"), (z["v_pad"], d), "normal", 0.02),
        Leaf(("embed", "unembed"), (d, z["v_pad"]), "normal", lec),
        Leaf(("final_norm", "scale"), (d,), "ones"),
        Leaf(("frontend", "w"), (z["inp"], d), "normal",
             1 / math.sqrt(z["inp"])),
        Leaf(("frontend", "b"), (d,), "zeros"),
        Leaf(per + ("norm1", "scale"), (L, d), "ones"),
        Leaf(per + ("mix", "wq"), (L, d, h, dh), "normal", lec),
        Leaf(per + ("mix", "wk"), (L, d, h, dh), "normal", lec),
        Leaf(per + ("mix", "wv"), (L, d, h, dh), "normal", lec),
        Leaf(per + ("mix", "wo"), (L, h, dh, d), "normal", 1 / math.sqrt(d)),
        Leaf(per + ("norm2", "scale"), (L, d), "ones"),
        Leaf(per + ("ffn", "w_up"), (L, d, f), "normal", lec),
        Leaf(per + ("ffn", "w_down"), (L, f, d), "normal", 1 / math.sqrt(f)),
    ]


def _layer(x: torch.Tensor, w: dict, i: int, z: dict, prec: Precision
           ) -> torch.Tensor:
    p = w["periods"]["0"]
    b, s, d = x.shape
    hn = prec.q(rmsnorm(x, p["norm1"]["scale"][i], z["eps"]))
    q, k, v = (hn @ prec.q(p["mix"][n][i].reshape(d, -1))
               for n in ("wq", "wk", "wv"))
    shape = (b, s, z["h"], z["dh"])
    o = attention(q.reshape(shape), k.reshape(shape), v.reshape(shape),
                  causal=False, prec=prec)
    x = x + prec.q(o.reshape(b, s, d)) @ prec.q(p["mix"]["wo"][i]
                                                .reshape(d, d))
    hn = prec.q(rmsnorm(x, p["norm2"]["scale"][i], z["eps"]))
    u = gelu_tanh(hn @ prec.q(p["ffn"]["w_up"][i]))
    return x + prec.q(u) @ prec.q(p["ffn"]["w_down"][i])


def logits(w: dict, spec: dict, frames: torch.Tensor,
           prec: Precision = FULL) -> torch.Tensor:
    """(B, S, padded units) logits of (B, S, conv_dim[-1]) frames; each
    layer checkpointed when gradients are on."""
    z = sizes(spec)
    x = prec.q(frames) @ prec.q(w["frontend"]["w"]) + w["frontend"]["b"]
    for i in range(z["L"]):
        if torch.is_grad_enabled():
            x = checkpoint(_layer, x, w, i, z, prec, use_reentrant=False)
        else:
            x = _layer(x, w, i, z, prec)
    x = rmsnorm(x, w["final_norm"]["scale"], z["eps"])
    return prec.q(x) @ prec.q(w["embed"]["unembed"])


def loss(w: dict, spec: dict, batch: dict, z_weight: float,
         prec: Precision = FULL) -> torch.Tensor:
    return lm_loss(logits(w, spec, batch["embeds"], prec), batch["labels"],
                   z_weight)


def model_ops(spec: dict, batch: int, seq: int, train: bool) -> float:
    """Operations of one forward (or training step) over ``batch`` x
    ``seq`` frames: the weight products (frontend, attention projections,
    MLP, head), 2 a weight a frame forward and 6 to train, plus the
    attention products over every (query head, key) pair, 4 D a pair
    forward and 10 D backward."""
    z = sizes(spec)
    d, f, L = z["d"], z["f"], z["L"]
    weights = z["inp"] * d + L * (4 * d * d + 2 * d * f) + d * z["v_pad"]
    pairs = batch * z["h"] * seq * seq
    attn = L * pairs * z["dh"] * (14 if train else 4)
    return float((6 if train else 2) * weights * batch * seq + attn)


def attention_shape(spec: dict, batch: int, seq: int) -> dict:
    """One layer's attention call: b, sq, sk, h, kh, d."""
    z = sizes(spec)
    return {"b": batch, "sq": seq, "sk": seq, "h": z["h"], "kh": z["h"],
            "d": z["dh"]}


def inputs(spec: dict) -> dict:
    """What a row of traffic holds: feature-extractor frames and the
    target unit of each."""
    return {"kind": "frames", "width": spec["conv_dim"][-1],
            "units": spec["num_target_units"]}
