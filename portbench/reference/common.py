"""Plain PyTorch pieces of the benchmark's references: weights drawn from a
seed, RMSNorm, attention, the Mamba-2 SSD scan, the LM loss and AdamW.

Everything computes in float32 (float64 where the inputs are float64), with
TF32 off. It imports nothing of the program under test: it is the yardstick
that decides ``correct``, so it is written from the published equations and
the training recipe that the configuration file states, and it works out
again whatever the program derives from the inputs.

Every product goes through :meth:`Precision.q` on its operands. In the
float32 reference that is the identity; the control (:data:`FP8`) rounds each
operand to float8 e4m3 with a per-tensor scale, as an fp8 run computes its
products, so the control reads what a step down from the configuration's
bf16 would give.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@dataclass(frozen=True)
class Precision:
    """How the reference rounds the operands of its products."""
    name: str

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name != "fp8":
            return t
        amax = t.detach().abs().amax().float().clamp_min(1e-30)
        scale = amax / E4M3_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) \
            * scale.to(t.dtype)
        # straight through: the backward's products see the rounded values
        return t + (rounded - t.detach())


FULL = Precision("fp32")
FP8 = Precision("fp8")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one random stream of a run (weights, data, ...)."""
    words = [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
             *[ord(c) for c in stream]]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0] >> 1)


# -- weights ------------------------------------------------------------------

@dataclass(frozen=True)
class Leaf:
    path: tuple[str, ...]
    shape: tuple[int, ...]
    init: str                 # normal | ones | zeros | a_log | dt_bias
    std: float = 0.0          # for normal


def make_weights(leaves: list[Leaf], seed: int, device, dtype
                 ) -> dict:
    """The weight tree, drawn on ``device`` from ``seed`` in a few large
    calls: one ``randn`` for every normal leaf, one ``rand`` for the
    uniform ones, each leaf a view of its buffer scaled in place."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    normal = [lf for lf in leaves if lf.init == "normal"]
    uniform = [lf for lf in leaves if lf.init in ("a_log", "dt_bias")]
    sizes = [math.prod(lf.shape) for lf in normal]
    buf = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out: dict = {}
    for lf, part in zip(normal, torch.split(buf, sizes)):
        _put(out, lf.path, part.view(lf.shape).mul_(lf.std))
    usizes = [math.prod(lf.shape) for lf in uniform]
    if uniform:
        ubuf = torch.rand(sum(usizes), generator=gen, device=device,
                          dtype=torch.float32)
        for lf, u in zip(uniform, torch.split(ubuf, usizes)):
            u = u.view(lf.shape)
            if lf.init == "a_log":          # A ~ U[1, 16], stored as log A
                val = torch.log(1.0 + 15.0 * u)
            else:                           # dt ~ log-uniform [1e-3, 1e-1]
                dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
                val = dt + torch.log(-torch.expm1(-dt))   # softplus^-1(dt)
            _put(out, lf.path, val.to(dtype))
    for lf in leaves:
        if lf.init in ("ones", "zeros"):
            fill = torch.ones if lf.init == "ones" else torch.zeros
            _put(out, lf.path, fill(lf.shape, device=device, dtype=dtype))
    return out


def _put(tree: dict, path: tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def leaf_items(tree, prefix: tuple[str, ...] = ()):
    """(path, tensor) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -- layers -------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, prec: Precision = FULL,
              q_block: int = 2048) -> torch.Tensor:
    """Softmax attention, q (B, S, H, D), k and v (B, S, K, D), H % K == 0,
    scale 1/sqrt(D): the whole softmax of one block of queries at a time,
    so that the scores of a long sequence fit."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kt = prec.q(k).permute(0, 2, 3, 1)                  # (B, H, D, S)
    vv = prec.q(v).transpose(1, 2)                      # (B, H, S, D)
    outs = []
    for i0 in range(0, s, q_block):
        qb = prec.q(q[:, i0:i0 + q_block]).transpose(1, 2)   # (B, H, q, D)
        sc = (qb @ kt) / math.sqrt(d)
        if causal:
            qi = torch.arange(i0, i0 + qb.shape[2], device=q.device)
            kj = torch.arange(s, device=q.device)
            sc = sc.masked_fill(kj[None, :] > qi[:, None], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append((prec.q(p) @ vv).transpose(1, 2))
    return torch.cat(outs, dim=1)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
             prec: Precision = FULL) -> torch.Tensor:
    """The Mamba-2 SSD recurrence h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, from a zero state, in the paper's chunked block form
    (arXiv:2405.21060, section 6) with the exponent masked above the
    diagonal before ``exp``. x (B, S, H, P), dt (B, S, H), a (H,), B and C
    (B, S, N). Returns y (B, S, H, P)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    x, bmat, cmat = prec.q(x), prec.q(bmat), prec.q(cmat)
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    xc = x.reshape(b, nc, c, h, p)
    dtc = dt.reshape(b, nc, c, h)
    bc = bmat.reshape(b, nc, c, n)
    cc = cmat.reshape(b, nc, c, n)
    cum = torch.cumsum(dtc * a, dim=2)                        # (B,Z,c,H)
    cb = torch.einsum("bzin,bzjn->bzij", cc, bc)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,Z,i,j,H)
    mask = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    dec = dec.masked_fill(~mask[:, :, None], float("-inf"))
    m = torch.exp(dec) * cb[..., None] * dtc[:, :, None, :, :]
    y = torch.einsum("bzijh,bzjhp->bzihp", prec.q(m), xc)
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc
    upd = torch.einsum("bzch,bzcn,bzchp->bzhpn", tail, bc, xc)
    decay = torch.exp(cum[:, :, -1])
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
    starts = []
    for z in range(nc):
        starts.append(state)
        state = decay[:, z, :, None, None] * state + upd[:, z]
    hs = torch.stack(starts, dim=1)
    y = y + torch.einsum("bzin,bzhpn->bzihp", cc, prec.q(hs)) * \
        torch.exp(cum)[..., None]
    return y.reshape(b, nc * c, h, p)[:, :s]


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, z_weight: float
            ) -> torch.Tensor:
    """Mean cross entropy over every position and every column of the
    logits, plus ``z_weight`` times the mean squared log-normaliser."""
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return nll.mean() + z_weight * lse.square().mean()


# -- AdamW --------------------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    """AdamW as the configuration's recipe states it: the global gradient
    norm clipped to ``grad_clip``, bias-corrected moments in float32, a
    float32 master copy, weight decay on every leaf of rank 2 or more as
    stored (layers stacked on a leading axis), a constant learning rate."""
    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float

    @classmethod
    def from_recipe(cls, o: dict) -> "AdamW":
        return cls(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                   weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])

    def clip_scale(self, grads: list[torch.Tensor]) -> torch.Tensor:
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        return torch.clamp_max(self.grad_clip / torch.clamp_min(norm, 1e-9),
                               1.0).to(grads[0].dtype)

    @torch.no_grad()
    def step(self, master: list[torch.Tensor], grads: list[torch.Tensor],
             m: list[torch.Tensor], v: list[torch.Tensor], count: int
             ) -> list[torch.Tensor]:
        """Updates master, m and v in place; returns the clipped
        gradients."""
        scale = self.clip_scale(grads)
        bc1 = 1.0 - self.b1 ** count
        bc2 = 1.0 - self.b2 ** count
        clipped = []
        for w, g, mi, vi in zip(master, grads, m, v):
            g = g * scale
            clipped.append(g)
            mi.mul_(self.b1).add_(g, alpha=1 - self.b1)
            vi.mul_(self.b2).add_(g.square(), alpha=1 - self.b2)
            upd = (mi / bc1) / (torch.sqrt(vi / bc2) + self.eps)
            if self.weight_decay > 0 and w.dim() >= 2:
                upd = upd + self.weight_decay * w
            w.sub_(self.lr * upd)
        return clipped
