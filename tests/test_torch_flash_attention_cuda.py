"""The CUDA flash-attention kernels (forward and backward) against their
plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present. The file imports
no jax, so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_flash_attention_cuda.py``.
"""
import pytest
import torch

from _flash_attention_cases import (ATOL_BF16, HOPPER_SHAPES, empty_rows_case,
                                    hopper_case, kernel_cases, random_case)
from repro_torch.kernels import flash_attention as fa

GRAD_ATOL = 1e-5     # float32 gradients against the plain version
LSE_ATOL = 1e-5      # the log-sum-exp against the plain version


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(case, device, dtype=torch.float32, grad=False):
    return [torch.from_numpy(case[n]).to(device, dtype).requires_grad_(grad)
            for n in ("q", "k", "v")]


def kw(case):
    return dict(causal=case["causal"], window=case["window"],
                q_offset=case["q_offset"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("name", sorted(kernel_cases()))
def test_kernel_matches_plain_on_card(name, dtype, cuda_device):
    case = kernel_cases()[name]
    q, k, v = inputs(case, cuda_device, dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw(case))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    # against the plain version in float32 on the same (rounded) inputs
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    **kw(case))
    tol = case["tol"] if dtype == torch.float32 else ATOL_BF16
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_rows_without_keys_are_zero_on_card(cuda_device):
    case, empty = empty_rows_case()
    q, k, v = inputs(case, cuda_device)
    got = fa.flash_attention(q, k, v, **kw(case))
    want = fa.flash_attention_plain(q, k, v, **kw(case))
    assert bool((got[:, empty] == 0).all())
    keep = [i for i in range(q.shape[1]) if i not in empty]
    torch.testing.assert_close(got[:, keep], want[:, keep], atol=2e-5,
                               rtol=2e-5)
    out, lse = fa.flash_attention_forward(q, k, v, **kw(case))
    assert bool((lse[:, :, empty] == -float("inf")).all())
    dq, _, _ = fa.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q),
                                      **kw(case))
    assert bool((dq[:, empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 40])
def test_gradients_through_kernel_on_card(window, cuda_device, monkeypatch):
    """FlashAttentionFn's gradients equal autograd through the plain
    version; its backward is one launch of the backward kernel and calls
    no plain version."""
    case = random_case(31, 2, 96, 96, 6, 2, 32, window=window)
    w = torch.randn(case["q"].shape, device=cuda_device,
                    generator=torch.Generator(device=cuda_device).manual_seed(1))

    def grads(fn):
        q, k, v = inputs(case, cuda_device, grad=True)
        out = fn(q, k, v, window=window, kv_chunk=32)
        return torch.autograd.grad((out * w).sum(), (q, k, v))
    want = grads(fa.flash_attention_plain)

    def plain_called(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")
    for name in ("flash_attention_plain", "flash_attention_lse_plain",
                 "flash_attention_bwd_plain"):
        monkeypatch.setattr(fa, name, plain_called)
    before = fa.flash_attention.launches, fa.flash_attention.bwd_launches
    got = grads(fa.flash_attention)
    assert (fa.flash_attention.launches, fa.flash_attention.bwd_launches) \
        == (before[0] + 1, before[1] + 1)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, atol=GRAD_ATOL, rtol=GRAD_ATOL)


@pytest.mark.cuda
def test_kernel_is_deterministic_on_card(cuda_device):
    """Two runs of the forward (output and lse) and of the backward are
    bit-identical: no atomics, a fixed summation order."""
    case = random_case(32, 2, 300, 300, 8, 2, 128, window=100)
    q, k, v = inputs(case, cuda_device, torch.bfloat16)
    a = fa.flash_attention(q, k, v, **kw(case))
    b = fa.flash_attention(q, k, v, **kw(case))
    assert torch.equal(a, b)
    out, lse = fa.flash_attention_forward(q, k, v, **kw(case))
    out2, lse2 = fa.flash_attention_forward(q, k, v, **kw(case))
    assert torch.equal(out, a) and torch.equal(out2, a)
    assert torch.equal(lse, lse2)
    g = torch.randn(q.shape, device=cuda_device, dtype=q.dtype,
                    generator=torch.Generator(device=cuda_device).manual_seed(2))
    first = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw(case))
    second = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw(case))
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("name", sorted(kernel_cases()))
def test_lse_matches_plain_on_card(name, dtype, cuda_device):
    case = kernel_cases()[name]
    q, k, v = inputs(case, cuda_device, dtype)
    _, lse = fa.flash_attention_forward(q, k, v, **kw(case))
    want = fa.flash_attention_lse_plain(q.float(), k.float(),
                                        **kw(case))
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    torch.testing.assert_close(lse, want, atol=LSE_ATOL, rtol=LSE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("name", sorted(kernel_cases()))
def test_backward_kernel_matches_plain_on_card(name, dtype, cuda_device):
    """dq, dk, dv of the backward kernel against its plain version in
    float32 on the same inputs and the forward kernel's out and lse:
    float32 within 1e-5, bf16 within 2e-2."""
    case = kernel_cases()[name]
    q, k, v = inputs(case, cuda_device, dtype)
    g = torch.randn(q.shape, device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(3)).to(dtype)
    out, lse = fa.flash_attention_forward(q, k, v, **kw(case))
    before = fa.flash_attention.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw(case))
    torch.cuda.synchronize()
    assert fa.flash_attention.bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out)), lse, g.float(), **kw(case))
    tol = GRAD_ATOL if dtype == torch.float32 else ATOL_BF16
    for t, w, ref in zip(got, want, (q, k, v)):
        assert t.dtype == dtype and t.shape == ref.shape
        torch.testing.assert_close(t.float(), w, atol=tol, rtol=tol)


@pytest.mark.cuda
def test_score_dtype_other_than_float32_raises_on_card(cuda_device):
    case = random_case(33, 1, 16, 16, 2, 1, 16)
    with pytest.raises(ValueError, match="float32 scores"):
        fa.flash_attention(*inputs(case, cuda_device),
                           score_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# the Hopper forward (wgmma, TMA, warp-specialised; bf16, D <= 128)
# ---------------------------------------------------------------------------


def _counts():
    return fa.flash_attention.launches, fa.flash_attention.wgmma_launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(HOPPER_SHAPES))
def test_hopper_forward_matches_plain_on_card(name, cuda_device):
    """Output and lse of the Hopper design against the plain versions in
    float32 on the same bf16 inputs (output 2e-2, lse 1e-5); one launch,
    counted as the Hopper design; a second run is bit-identical."""
    case = hopper_case(name)
    q, k, v = inputs(case, cuda_device, torch.bfloat16)
    before = _counts()
    out, lse = fa.flash_attention_forward(q, k, v, **kw(case))
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    **kw(case))
    torch.testing.assert_close(out.float(), want, atol=ATOL_BF16,
                               rtol=ATOL_BF16)
    want_lse = fa.flash_attention_lse_plain(q.float(), k.float(), **kw(case))
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=LSE_ATOL)
    out2, lse2 = fa.flash_attention_forward(q, k, v, **kw(case))
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_hopper_forward_rows_without_keys_on_card(cuda_device):
    """In bf16 too, a query with no valid key gets exact zeros and lse
    -inf from the Hopper design."""
    case, empty = empty_rows_case()
    q, k, v = inputs(case, cuda_device, torch.bfloat16)
    before = _counts()
    out, lse = fa.flash_attention_forward(q, k, v, **kw(case))
    assert _counts()[1] == before[1] + 1
    assert bool((out[:, empty] == 0).all())
    assert bool((lse[:, :, empty] == -float("inf")).all())
    keep = [i for i in range(q.shape[1]) if i not in empty]
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    **kw(case))
    torch.testing.assert_close(out[:, keep].float(), want[:, keep],
                               atol=ATOL_BF16, rtol=ATOL_BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hubert_crop_781", "internvl2_g7_1170"])
def test_hopper_forward_gradients_on_card(name, cuda_device):
    """Gradients through FlashAttentionFn in bf16 (the Hopper forward, the
    backward kernel) against autograd through the plain version in float32
    on the same rounded inputs, within the bf16 tolerance."""
    case = hopper_case(name)
    q0, k0, v0 = inputs(case, cuda_device, torch.bfloat16)
    w = torch.randn(q0.shape, device=cuda_device,
                    generator=torch.Generator(device=cuda_device)
                    .manual_seed(4))

    def grads(fn, dtype):
        q, k, v = (t.detach().to(dtype).requires_grad_(True)
                   for t in (q0, k0, v0))
        out = fn(q, k, v, **kw(case))
        return torch.autograd.grad((out.float() * w).sum(), (q, k, v))
    want = grads(fa.flash_attention_plain, torch.float32)
    before = _counts()
    got = grads(fa.flash_attention, torch.bfloat16)
    assert _counts()[1] == before[1] + 1
    for g, wg in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float(), wg, atol=ATOL_BF16,
                                   rtol=ATOL_BF16)


@pytest.mark.cuda
def test_hopper_forward_reads_strided_and_unaligned_inputs_on_card(
        cuda_device):
    """q, k, v as views of one fused (B, S, 3, H, D) projection are read
    in place; a base that is not 16-byte aligned is copied first (TMA
    reads neither such a base nor such strides). Both match the plain
    version."""
    case = hopper_case("hubert_crop_781")
    q, k, v = inputs(case, cuda_device, torch.bfloat16)
    fused = torch.stack((q, k, v), dim=2)
    qs, ks, vs = fused.unbind(2)
    assert not qs.is_contiguous() and fa._tma_ok(qs)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    **kw(case))
    got = fa.flash_attention(qs, ks, vs, **kw(case))
    torch.testing.assert_close(got.float(), want, atol=ATOL_BF16,
                               rtol=ATOL_BF16)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert not fa._tma_ok(shifted)
    got = fa.flash_attention(shifted, k, v, **kw(case))
    torch.testing.assert_close(got.float(), want, atol=ATOL_BF16,
                               rtol=ATOL_BF16)


@pytest.mark.cuda
def test_wgmma_launches_count_only_the_hopper_design_on_card(cuda_device):
    """A hubert-shaped bf16 call adds 1 to both counters; a bf16 call at
    D = 256 (mma.sync) and a float32 call (the FMA design) add 1 to
    ``launches`` and 0 to ``wgmma_launches``."""
    for (d, dtype), add in (((80, torch.bfloat16), 1),
                            ((256, torch.bfloat16), 0),
                            ((80, torch.float32), 0)):
        case = random_case(34, 1, 256, 256, 16 if d == 80 else 4,
                           16 if d == 80 else 1, d, causal=d != 80)
        before = _counts()
        fa.flash_attention(*inputs(case, cuda_device, dtype), **kw(case))
        torch.cuda.synchronize()
        assert _counts() == (before[0] + 1, before[1] + add)
