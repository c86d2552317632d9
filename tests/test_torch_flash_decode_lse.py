"""The flash-decode log-sum-exp output and the merge of sequence shards.

``flash_decode(..., return_lse=True)`` returns each head's log-sum-exp
beside its output; the sequence-parallel decode island of the sharded
serve step launches it on each rank's slice of a sequence-sharded cache
and merges the slices by their log-sum-exps. On the CPU the plain version
is held to ``chunked_attention``'s running statistics (``m + log l``) and
to a float64 oracle, and the merge of 2, 4 and 8 shards (each a slice of
gemma3-1b's global decode cache, positions kept global, launched unbounded)
to the whole cache's attention. A shard with no valid key gives zeros and
``-inf``, and the merge gives no NaN even where every shard is empty.

The ``cuda``-marked twins hold the kernel's output and log-sum-exp to the
plain version's on the card (float32 at ``ATOL_F32``, bf16 at
``ATOL_BF16``, the tolerances of the other decode tests) and skip here. The
file imports no jax:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_decode_lse.py``.
"""
import math

import numpy as np
import pytest
import torch

from _flash_decode_cases import (ATOL_BF16, ATOL_F32, CASES, ISLAND_TP,
                                 island_case, lse_oracle, oracle, shard_rows)
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.attention import chunked_attention

DENSE = sorted(n for n in CASES if CASES[n]()["kind"] == "dense")
LSE_ATOL = 1e-4     # float32 log-sum-exps of O(10) scores


def _t(case, device, dtype, k=None, v=None, kpos=None):
    return (torch.from_numpy(case["q"]).to(device, dtype),
            torch.from_numpy(case["k"] if k is None else k).to(device, dtype),
            torch.from_numpy(case["v"] if v is None else v).to(device, dtype),
            torch.from_numpy(case["qpos"]).to(device),
            torch.from_numpy(case["kpos"] if kpos is None else kpos
                             ).to(device))


def _empty_lanes(case):
    kpos, qpos = case["kpos"], case["qpos"]
    ok = (kpos >= 0) & (kpos <= qpos[:, None])
    if case["window"] is not None:
        ok &= kpos > qpos[:, None] - case["window"]
    return ~ok.any(1)


@pytest.mark.parametrize("name", DENSE)
def test_plain_lse_matches_chunked_stats_and_oracle(name):
    case = CASES[name]()
    q, k, v, qpos, kpos = _t(case, "cpu", torch.float32)
    out, lse = fd.flash_decode_ref(q, k, v, qpos, kpos,
                                   window=case["window"],
                                   block_k=case["block_k"],
                                   bounded=case["bounded"], return_lse=True)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), oracle(case), atol=ATOL_F32)
    want = lse_oracle(case)
    empty = _empty_lanes(case)
    np.testing.assert_allclose(lse.numpy()[~empty], want[~empty],
                               atol=LSE_ATOL)
    assert np.isneginf(lse.numpy()[empty]).all()
    # chunked_attention's statistics: m + log(l) where a key is attended
    # (it does not mask p, so a lane without one has l > 0 there)
    o2, m, l = chunked_attention(q, k, v, q_offset=qpos, k_positions=kpos,
                                 k_valid=kpos >= 0, causal=True,
                                 window=case["window"], kv_chunk=64,
                                 return_stats=True)
    np.testing.assert_allclose((m + torch.log(l)).numpy()[~empty],
                               want[~empty], atol=LSE_ATOL)
    np.testing.assert_allclose(o2.numpy()[~empty], out.numpy()[~empty],
                               atol=ATOL_F32)


def _shards(case, tp, device, dtype, fn):
    outs, lses = [], []
    for k, v, kpos in shard_rows(case, tp):
        q, kk, vv, qpos, kp = _t(case, device, dtype, k, v, kpos)
        o, lse = fn(q, kk, vv, qpos, kp, bounded=False, return_lse=True)
        outs.append(o)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def _merge(outs, lses):
    """The island's merge over shards stacked on dim 0."""
    return fd.merge_lse(outs, lses, lambda t: t.amax(0), lambda t: t.sum(0))


@pytest.mark.parametrize("tp", ISLAND_TP)
def test_plain_shards_merge_to_the_whole_cache(tp):
    """The merged shards against the plain attention over the whole cache
    (both float32 inside: within 1e-6) and against the float64 oracle."""
    case = island_case()
    outs, lses = _shards(case, tp, "cpu", torch.float32, fd.flash_decode_ref)
    empty = torch.isneginf(lses).all(-1).all(-1).all(-1)
    assert empty.any(), "every split has a shard past every position"
    assert (outs[empty] == 0).all()
    q, k, v, qpos, kpos = _t(case, "cpu", torch.float32)
    whole = fd.flash_decode_ref(q, k, v, qpos, kpos, bounded=False)
    merged = _merge(outs, lses)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=1e-6)
    np.testing.assert_allclose(merged.numpy(), oracle(case), atol=ATOL_F32)


def test_merge_of_empty_shards_gives_zeros_not_nan():
    outs = torch.zeros(3, 2, 1, 4, 8)
    lses = torch.full((3, 2, 1, 4), -math.inf)
    lses[1, 0] = 0.5                  # slot 0 has one non-empty shard
    outs[1, 0] = 1.0
    got = _merge(outs, lses)
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()
    torch.testing.assert_close(got[0], torch.ones(1, 4, 8))


def test_meta_tensors_take_the_plain_version_and_launch_nothing():
    case = island_case()
    q, k, v, qpos, kpos = (x.to("meta") for x in _t(case, "cpu",
                                                     torch.float32))
    before = (fd.flash_decode.launches, fd.flash_decode.lse_launches)
    out, lse = fd.flash_decode(q, k, v, qpos, kpos, return_lse=True)
    assert out.device.type == "meta" and out.shape == q.shape
    assert lse.shape == q.shape[:3]
    assert (fd.flash_decode.launches, fd.flash_decode.lse_launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSE)
def test_kernel_lse_matches_plain_f32(name, cuda_device):
    case = CASES[name]()
    args = _t(case, cuda_device, torch.float32)
    kw = dict(window=case["window"], bounded=case["bounded"])
    before = (fd.flash_decode.launches, fd.flash_decode.lse_launches)
    out, lse = fd.flash_decode(*args, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (fd.flash_decode.launches, fd.flash_decode.lse_launches) == \
        (before[0], before[1] + 1)
    want_o, want_l = fd.flash_decode_ref(*args, return_lse=True, **kw)
    assert torch.equal(out, fd.flash_decode(*args, **kw))
    torch.testing.assert_close(out, want_o, atol=ATOL_F32, rtol=0)
    empty = torch.from_numpy(_empty_lanes(case)).to(cuda_device)
    assert torch.isneginf(lse[empty]).all()
    torch.testing.assert_close(lse[~empty], want_l[~empty], atol=LSE_ATOL,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", ISLAND_TP)
def test_kernel_shards_merge_to_the_whole_cache(tp, dtype, cuda_device):
    """Each shard one LSE launch with its global positions (unbounded),
    against the plain version on the same inputs; the merge against the
    plain attention over the whole cache."""
    case = island_case()
    tol = ATOL_F32 if dtype == torch.float32 else ATOL_BF16
    outs, lses = _shards(case, tp, cuda_device, dtype, fd.flash_decode)
    p_outs, p_lses = _shards(case, tp, cuda_device, dtype,
                             fd.flash_decode_ref)
    empty = torch.isneginf(p_lses).all(-1).all(-1).all(-1)
    assert empty.any()
    assert (outs[empty] == 0).all() and torch.isneginf(lses[empty]).all()
    torch.testing.assert_close(outs[~empty].float(), p_outs[~empty].float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lses[~empty], p_lses[~empty],
                               atol=LSE_ATOL, rtol=0)
    q, k, v, qpos, kpos = _t(case, cuda_device, dtype)
    whole = fd.flash_decode_ref(q, k, v, qpos, kpos, bounded=False)
    merged = _merge(outs, lses)
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, whole.float(), atol=tol, rtol=tol)
