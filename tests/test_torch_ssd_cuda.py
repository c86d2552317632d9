"""The CUDA SSD-scan kernel against its plain PyTorch version, on the card.

Marked ``cuda``: they skip where no CUDA device is present. The file imports
no jax, so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py``.
"""
import pytest
import torch

from _ssd_cases import (ATOL_BF16, ATOL_F32, KERNEL_SHAPES, kernel_case,
                        state_cases)
from repro_torch.kernels import ssd

NAMES = ("x", "dt", "a", "b", "c")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(case, device, dtype=torch.float32, grad=False):
    out = []
    for k in NAMES:
        t = torch.from_numpy(case[k]).to(device)
        if k in ("x", "b", "c"):
            t = t.to(dtype)
        out.append(t.requires_grad_(grad))
    h0 = case["h0"]
    if h0 is not None:
        h0 = torch.from_numpy(h0).to(device).requires_grad_(grad)
    return out, h0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, ATOL_F32),
                                       (torch.bfloat16, ATOL_BF16)])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_kernel_matches_plain_on_card(shape, dtype, tol, cuda_device):
    case = kernel_case(*shape)
    args, _ = inputs(case, cuda_device, dtype)
    before = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(*args, chunk=case["chunk"])
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    want_y, want_h = ssd.ssd_scan_plain(*args, chunk=case["chunk"])
    assert y.dtype == dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, want_h, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(state_cases()))
def test_kernel_state_and_ragged_on_card(name, cuda_device):
    case = state_cases()[name]
    args, h0 = inputs(case, cuda_device)
    y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
    torch.cuda.synchronize()
    want_y, want_h = ssd.ssd_scan_plain(*args, chunk=case["chunk"], h0=h0)
    torch.testing.assert_close(y, want_y, atol=ATOL_F32, rtol=ATOL_F32)
    torch.testing.assert_close(h, want_h, atol=ATOL_F32, rtol=ATOL_F32)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda_device):
    case = state_cases()["width"]
    args, h0 = inputs(case, cuda_device, torch.bfloat16)
    first = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
    for _ in range(3):
        again = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["h0", "ragged_100", "overflow"])
def test_autograd_matches_plain_on_card(name, cuda_device):
    case = state_cases()[name]
    args, h0 = inputs(case, cuda_device, grad=True)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    wy = torch.randn(args[0].shape, generator=gen, device=cuda_device)
    leaves = [*args] + ([h0] if h0 is not None else [])

    def grads(fn):
        y, h = fn(*args, chunk=case["chunk"], h0=h0)
        loss = (y * wy).sum() + h.square().sum()
        return torch.autograd.grad(loss, leaves)
    got = grads(ssd.ssd_scan)
    want = grads(ssd.ssd_scan_plain)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
