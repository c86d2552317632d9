"""The references against float64 at small sizes: the chunked SSD scan
against the plain recurrence, blocked attention against one softmax, each
model's loss in float32 against float64, AdamW against ``torch.optim``."""
import math

import pytest
import torch

from portbench.reference import common, hubert, mamba2
from portbench.tiny import SPECS


def _recurrence(x, dt, a, bm, cm):
    b, s, h, p = x.shape
    state = torch.zeros(b, h, p, bm.shape[-1], dtype=x.dtype)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                      # (B, H)
        state = decay[..., None, None] * state + torch.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t]))
    return torch.stack(ys, dim=1)


@pytest.mark.parametrize("s,chunk", [(40, 16), (32, 32), (7, 16)])
def test_ssd_scan_is_the_recurrence(s, chunk):
    g = torch.Generator().manual_seed(s)
    x = torch.randn(2, s, 3, 4, generator=g, dtype=torch.float64)
    dt = torch.rand(2, s, 3, generator=g, dtype=torch.float64) * 0.5
    a = -torch.rand(3, generator=g, dtype=torch.float64) * 4 - 0.5
    bm = torch.randn(2, s, 5, generator=g, dtype=torch.float64)
    cm = torch.randn(2, s, 5, generator=g, dtype=torch.float64)
    want = _recurrence(x, dt, a, bm, cm)
    got = common.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    assert torch.allclose(got, want, atol=1e-10, rtol=1e-10)
    got32 = common.ssd_scan(x.float(), dt.float(), a.float(), bm.float(),
                            cm.float(), chunk=chunk)
    assert (got32.double() - want).abs().max() < 1e-4 * want.abs().max()


@pytest.mark.parametrize("causal", [False, True])
def test_attention_blocks_are_one_softmax(causal):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 13, 4, 8, generator=g, dtype=torch.float64)
               for _ in range(3))
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(8)
    if causal:
        sc = sc.masked_fill(torch.ones(13, 13).triu(1).bool(), float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
    got = common.attention(q, k, v, causal=causal, q_block=5)
    assert torch.allclose(got, want, atol=1e-12)
    kv = (k[:, :, :2], v[:, :, :2])          # 4 query heads on 2 KV heads
    got_g = common.attention(q, *kv, causal=causal, q_block=4)
    want_g = common.attention(q, *(t.repeat_interleave(2, 2) for t in kv),
                              causal=causal)
    assert torch.allclose(got_g, want_g, atol=1e-12)


def _spec(name, family):
    base = {"name": name, "family": family, "pad_vocab_size_multiple": 256,
            "norm_epsilon": 1e-5, "layer_norm_eps": 1e-5, "d_conv": 4,
            "expand": 2, "tie_embeddings": True, "num_target_units": 504}
    return dict(base, **SPECS[name])


@pytest.mark.parametrize("family", ["mamba2", "hubert"])
def test_loss_float32_against_float64(family):
    name = "mamba2-130m" if family == "mamba2" else "hubert-xlarge"
    mod = mamba2 if family == "mamba2" else hubert
    spec = _spec(name, family)
    w = common.make_weights(mod.weight_leaves(spec), 5, "cpu", torch.float32)
    g = torch.Generator().manual_seed(2)
    if family == "mamba2":
        ids = torch.randint(0, 300, (2, 65), generator=g)
        batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    else:
        batch = {"embeds": torch.randn(2, 40, 32, generator=g),
                 "labels": torch.randint(0, 504, (2, 40), generator=g)}
    want = mod.loss(common.tree_map(lambda t: t.double(), w), spec,
                    {k: v.double() if v.is_floating_point() else v
                     for k, v in batch.items()}, 1e-4)
    got = mod.loss(w, spec, batch, 1e-4)
    assert abs(float(got) - float(want)) < 1e-6 * abs(float(want))


def test_adamw_is_torch_adamw_after_clipping():
    g = torch.Generator().manual_seed(3)
    ws = [torch.randn(3, 4, generator=g, dtype=torch.float64),
          torch.randn(5, generator=g, dtype=torch.float64)]
    opt = common.AdamW(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8,
                       weight_decay=0.1, grad_clip=0.5)
    params = [torch.nn.Parameter(w.clone()) for w in ws]
    ref = torch.optim.AdamW([{"params": params[:1], "weight_decay": 0.1},
                             {"params": params[1:], "weight_decay": 0.0}],
                            lr=1e-2, betas=(0.9, 0.95), eps=1e-8)
    m = [torch.zeros_like(w) for w in ws]
    v = [torch.zeros_like(w) for w in ws]
    for step in (1, 2, 3):
        grads = [torch.randn(w.shape, generator=g, dtype=torch.float64)
                 for w in ws]
        clipped = opt.step(ws, grads, m, v, step)
        for p, c in zip(params, clipped):
            p.grad = c.clone()
        norm = math.sqrt(sum(float(x.square().sum()) for x in grads))
        assert math.isclose(
            math.sqrt(sum(float(c.square().sum()) for c in clipped)),
            min(norm, 0.5), rel_tol=1e-12)
        ref.step()
    for w, p in zip(ws, params):
        assert torch.allclose(w, p.detach(), atol=1e-12)


def test_fp8_control_rounds_to_e4m3():
    x = torch.linspace(-3, 3, 101, dtype=torch.float32, requires_grad=True)
    y = common.FP8.q(x)
    rel = ((y - x).abs() / x.abs().clamp_min(1e-3)).max().detach()
    assert 1e-3 < float(rel) <= 2 ** -4 + 1e-6
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))      # straight through
    assert common.FULL.q(x) is x
