"""The CUDA SSD-scan kernels (forward and backward) against their plain
PyTorch versions, on the card.

Marked ``cuda``: they skip where no CUDA device is present. The file imports
no jax, so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_cuda.py``.
"""
import pytest
import torch

from _ssd_cases import (ATOL_BF16, ATOL_F32, BWD_REL_BF16, KERNEL_SHAPES,
                        MAIN_SHAPE, kernel_case, state_cases)
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
    # the reference in float64 on the same inputs: the backward is a kernel,
    # not autograd through the plain version, and on the overflowing chunk
    # the plain version's float32 da is 2.2e-4 from the kernel's (see
    # plain_bwd_f64)
    leaves64 = [t.detach().double().requires_grad_(True) for t in leaves]

    def grads(fn, ins):
        y, h = fn(*ins[:5], chunk=case["chunk"],
                  h0=ins[5] if h0 is not None else None)
        loss = (y * wy).sum() + h.square().sum()
        return torch.autograd.grad(loss, ins)
    got = grads(ssd.ssd_scan, leaves)
    want = grads(ssd.ssd_scan_plain, leaves64)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.double(), w, atol=1e-4, rtol=1e-4)


BWD_CASES = {**{name: case for name, case in state_cases().items()},
             **{str(shape): kernel_case(*shape) for shape in KERNEL_SHAPES}}
OUTS = ("dx", "ddt", "da", "dB", "dC", "dh0")


def cotangents(y, h, seed=0):
    gen = torch.Generator(device=y.device).manual_seed(seed)
    return (torch.randn(y.shape, generator=gen, device=y.device).to(y.dtype),
            torch.randn(h.shape, generator=gen, device=y.device))


def plain_bwd_f64(args, gy, gh, chunk, h0):
    """ssd_scan_bwd_plain in float64 on the same float32 inputs. The
    reference is float64: where |cum| is large (up to 466 on the
    overflowing chunk, an ulp of 3e-5) the plain version's own float32
    exponents are off by the order of the 1e-4 tolerance, and its float32
    gradient differs from the kernel's by up to twice that."""
    f64 = lambda t: None if t is None else t.double()   # noqa: E731
    return ssd.ssd_scan_bwd_plain(*map(f64, args), f64(gy), f64(gh),
                                  chunk=chunk, h0=f64(h0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_bwd_kernel_matches_plain_on_card(name, cuda_device):
    case = BWD_CASES[name]
    args, h0 = inputs(case, cuda_device)
    y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
    gy, gh = cotangents(y, h)
    before = ssd.ssd_scan.bwd_launches
    got = ssd.ssd_scan_bwd(*args, gy, gh, h0=h0)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.bwd_launches == before + 1
    want = plain_bwd_f64(args, gy, gh, case["chunk"], h0)
    for out, g, w in zip(OUTS, got, want):
        if out == "dh0" and h0 is None:
            assert g is None
            continue
        assert bool(torch.isfinite(g).all()), out
        torch.testing.assert_close(g.double(), w, atol=ATOL_F32,
                                   rtol=ATOL_F32, msg=out)


@pytest.mark.cuda
@pytest.mark.parametrize("present", ["gy", "g_hfin"])
def test_bwd_kernel_with_one_cotangent(present, cuda_device):
    case = state_cases()["ragged_100"]
    args, h0 = inputs(case, cuda_device)
    y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
    gy, gh = cotangents(y, h)
    gy, gh = (gy, None) if present == "gy" else (None, gh)
    got = ssd.ssd_scan_bwd(*args, gy, gh, h0=h0)
    want = plain_bwd_f64(args, gy, gh, case["chunk"], h0)
    for out, g, w in zip(OUTS, got, want):
        torch.testing.assert_close(g.double(), w, atol=ATOL_F32,
                                   rtol=ATOL_F32, msg=out)


def main_inputs(device, seed=0):
    """One mamba2-130m layer's SSD inputs at the training shape, laid out as
    ssd_block hands them over: x a view of the conv output, B and C slices
    of it (bf16); dt in [1e-3, 0.1], a in [-16, -1]."""
    m = MAIN_SHAPE
    b, s, h, p, n = m["b"], m["s"], m["h"], m["p"], m["n"]
    gen = torch.Generator(device=device).manual_seed(seed)
    xbc = torch.randn((b, s, h * p + 2 * n), generator=gen, device=device,
                      dtype=torch.bfloat16)
    dt = torch.rand((b, s, h), generator=gen, device=device) * 0.099 + 1e-3
    a = -(torch.rand((h,), generator=gen, device=device) * 15 + 1)
    return [xbc[..., :h * p].reshape(b, s, h, p), dt, a,
            xbc[..., h * p:h * p + n], xbc[..., h * p + n:]]


@pytest.mark.cuda
def test_bwd_kernel_bf16_training_shape(cuda_device):
    args = main_inputs(cuda_device)
    y, h = ssd.ssd_scan(*args)
    gy, gh = cotangents(y, h)
    got = ssd.ssd_scan_bwd(*args, gy, gh)
    f32 = [t.float() for t in args]
    want = ssd.ssd_scan_bwd_plain(*f32, gy.float(), gh,
                                  chunk=MAIN_SHAPE["chunk"])
    for out, g, w in zip(OUTS[:5], got, want):
        assert bool(torch.isfinite(g).all()), out
        rel = float((g.float() - w).norm() / w.norm())
        assert rel <= BWD_REL_BF16, (out, rel)


@pytest.mark.cuda
def test_bwd_kernel_is_deterministic(cuda_device):
    case = state_cases()["width"]
    args, h0 = inputs(case, cuda_device, torch.bfloat16)
    y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
    gy, gh = cotangents(y, h)
    first = ssd.ssd_scan_bwd(*args, gy, gh, h0=h0)
    for _ in range(3):
        again = ssd.ssd_scan_bwd(*args, gy, gh, h0=h0)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_one_bwd_launch_per_backward_no_plain(cuda_device, monkeypatch):
    case = state_cases()["h0"]
    args, h0 = inputs(case, cuda_device, grad=True)

    def plain(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(ssd, "ssd_scan_plain", plain)
    monkeypatch.setattr(ssd, "ssd_scan_bwd_plain", plain)
    before = ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches
    y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
    torch.autograd.grad(y.square().sum() + h.sum(), [*args, h0])
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
