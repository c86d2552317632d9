"""The yardstick's bounds and the model-operation counts against hand counts
at small shapes."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import yardstick as ys
from portbench.reference import common, hubert, mamba2
from portbench.tiny import SPECS


def test_ssd_work_by_hand():
    # B=1, S=256 (one chunk), H=1, P=2, N=3, bf16
    ops, nbytes = ys.ssd_fwd_work(1, 256, 1, 2, 3)
    tri = 256 * 257 // 2
    assert ops == tri * 3 * 2 + (tri * 2 * 2 + 256 * 3 * 2 * 2 * 2 + 2 * 3 * 2)
    assert nbytes == 2 * 256 * 2 * 2 + 256 * 4 + 4 + 2 * 256 * 3 * 2 + 6 * 4
    ops, nbytes = ys.ssd_bwd_work(1, 256, 1, 2, 3)
    assert ops == 3 * tri * 3 * 2 + (2 * tri * 2 * 2 + 5 * 256 * 3 * 2 * 2
                                     + 2 * 2 * 3 * 2)
    assert nbytes == 3 * 256 * 2 * 2 + 2 * 256 * 4 + 2 * 4 + 4 * 256 * 3 * 2
    # a ragged length counts a whole chunk's products
    assert ys.ssd_fwd_work(1, 257, 1, 2, 3)[0] > 2 * ys.ssd_fwd_work(
        1, 256, 1, 2, 3)[0] - 1


@pytest.mark.parametrize("b,sq,sk,h,kh,d", [(2, 9, 9, 3, 1, 4),
                                             (1, 7, 5, 4, 4, 8),
                                             (3, 1, 11, 2, 2, 16)])
def test_attention_work_by_brute_force(b, sq, sk, h, kh, d):
    pairs = sum(1 for _ in range(b) for _ in range(h) for _ in range(sq)
                for _ in range(sk))
    ops, nbytes = ys.attention_work(b, sq, sk, h, kh, d)
    assert ops == 4 * d * pairs
    assert nbytes == 2 * d * 2 * (b * sq * h + b * sk * kh)
    ops_b, bytes_b = ys.attention_work(b, sq, sk, h, kh, d, backward=True)
    assert ops_b == 10 * d * pairs and bytes_b == 2 * nbytes


def test_least_seconds_takes_the_larger_bound():
    assert ys.least_seconds((989e12, 0.0)) == pytest.approx(1.0)
    assert ys.least_seconds((0.0, 3.35e12)) == pytest.approx(1.0)
    assert ys.least_seconds((989e12, 2 * 3.35e12)) == pytest.approx(2.0)


def _spec(name, family):
    base = {"name": name, "family": family, "pad_vocab_size_multiple": 256,
            "norm_epsilon": 1e-5, "layer_norm_eps": 1e-5, "d_conv": 4,
            "expand": 2, "tie_embeddings": True, "num_target_units": 504}
    return dict(base, **SPECS[name])


def test_mamba2_ops_by_hand():
    s = _spec("mamba2-130m", "mamba2")   # d 64, di 128, n 16, h 8, 2 layers
    in_proj = 64 * (2 * 128 + 2 * 16 + 8)
    conv = 4 * (128 + 2 * 16)
    out_proj = 128 * 64
    table = 512 * 64                      # 300 padded to 256's multiple
    weights = 2 * (in_proj + conv + out_proj) + table
    assert mamba2.model_ops(s, 3, 5, train=False) == 2 * weights * 15
    assert mamba2.model_ops(s, 3, 5, train=True) == 6 * weights * 15


def test_hubert_ops_against_counted_products():
    s = _spec("hubert-xlarge", "hubert")
    w = common.make_weights(hubert.weight_leaves(s), 3, "cpu", torch.float32)
    frames = torch.randn(2, 24, 32)
    with FlopCounterMode(display=False) as fc:
        hubert.logits(w, s, frames)
    # the reference's products are the model's: frontend, q/k/v/o, MLP,
    # head, and attention's two products over every pair
    assert hubert.model_ops(s, 2, 24, train=False) == fc.get_total_flops()
    d, f, h, dh = 64, 128, 4, 16
    weights = 32 * d + 2 * (4 * d * d + 2 * d * f) + d * 512
    attn = 2 * (2 * h * 24 * 24) * dh * 14
    assert hubert.model_ops(s, 2, 24, train=True) == 6 * weights * 48 + attn
