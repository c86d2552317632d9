"""The port's SSD scan (plain version and wrapper) against the JAX package,
on the CPU.

* ``ssd_scan_plain`` against the Pallas kernel ``repro.kernels.ssd.ssd_scan``
  in interpret mode on the cases of ``tests/test_kernels.py`` (f32 atol
  1e-4, bf16 5e-2), and against the model's ``repro.models.ssd.ssd_chunked``
  with an initial state, the final state and ragged lengths (1e-4).
* Its output does not depend on the chunk.
* Its gradients equal ``jax.grad`` of ``ssd_chunked`` wherever the
  reference's are finite (atol 1e-4), and on a chunk whose unmasked
  exponent overflows the reference's gradient is NaN while the port's is
  finite and agrees with a float64 central difference.
* On a CPU tensor the wrapper takes the plain version and launches nothing.
* ``ssd_scan_bwd_plain``, the backward kernel's plain version (explicit
  formulas), equals ``jax.grad`` of ``ssd_chunked`` wherever the reference
  is finite (1e-4), and autograd through ``ssd_scan_plain`` on every state
  case (the overflowing chunk included) and every kernel case, in float64
  (1e-10: the same function, rounding only) and float32 (1e-4), also with
  either cotangent absent.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _ssd_cases import (ATOL_BF16, ATOL_F32, KERNEL_SHAPES, kernel_case,
                        random_case, state_cases, unmasked_exponent_max)
from repro.kernels.ssd import ssd_scan as jax_ssd_scan
from repro.models.ssd import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ssd
from repro_torch.kernels.ssd import (ssd_scan, ssd_scan_bwd,
                                     ssd_scan_bwd_plain, ssd_scan_plain)

NAMES = ("x", "dt", "a", "b", "c")


def _torch(case, dtype=torch.float32, grad=False):
    out = []
    for k in NAMES:
        t = torch.from_numpy(case[k])
        if k in ("x", "b", "c"):
            t = t.to(dtype)
        out.append(t.requires_grad_(grad))
    h0 = case["h0"]
    h0 = None if h0 is None else torch.from_numpy(h0).requires_grad_(grad)
    return out, h0


def _jax(case, dtype=jnp.float32):
    out = [jnp.asarray(case[k], dtype if k in ("x", "b", "c") else
                       jnp.float32) for k in NAMES]
    return out, None if case["h0"] is None else jnp.asarray(case["h0"])


@pytest.mark.parametrize("dtype,tol", [("float32", ATOL_F32),
                                       ("bfloat16", ATOL_BF16)])
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_plain_matches_pallas_interpret(shape, dtype, tol):
    case = kernel_case(*shape)
    jin, _ = _jax(case, jnp.dtype(dtype))
    want = jax_ssd_scan(*jin, chunk=case["chunk"], interpret=True)
    tin, _ = _torch(case, getattr(torch, dtype))
    got, _ = ssd_scan_plain(*tin, chunk=case["chunk"])
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("name", sorted(state_cases()))
def test_plain_matches_ssd_chunked_with_state(name):
    case = state_cases()[name]
    jin, jh0 = _jax(case)
    want_y, want_h = jax_ssd_chunked(*jin, chunk=case["chunk"], h0=jh0)
    tin, th0 = _torch(case)
    before = ssd_scan.launches
    got_y, got_h = ssd_scan(*tin, chunk=case["chunk"], h0=th0)
    assert ssd_scan.launches == before      # the CPU launches no kernel
    assert got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=ATOL_F32, rtol=ATOL_F32)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                               atol=ATOL_F32, rtol=ATOL_F32)


@pytest.mark.parametrize("chunk", [8, 16, 48, 64])
def test_plain_is_chunk_invariant(chunk):
    case = random_case(7, 2, 96, 2, 16, 8, 96, h0=True)
    tin, th0 = _torch(case)
    whole = ssd_scan_plain(*tin, chunk=96, h0=th0)
    part = ssd_scan_plain(*tin, chunk=chunk, h0=th0)
    for g, w in zip(part, whole):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=2e-4)


def _jax_grads(case):
    """jax.grad of sum(y * wy) + sum(h * wh) through ssd_chunked."""
    jin, jh0 = _jax(case)
    rng = np.random.RandomState(11)
    wy = rng.randn(*case["x"].shape).astype(np.float32)
    wh = rng.randn(case["x"].shape[0], case["x"].shape[2],
                   case["x"].shape[3], case["b"].shape[2]).astype(np.float32)

    def f(x, dt, a, b, c, h0):
        y, h = jax_ssd_chunked(x, dt, a, b, c, chunk=case["chunk"], h0=h0)
        return jnp.sum(y * wy) + jnp.sum(h * wh)
    h0 = jh0 if jh0 is not None else jnp.zeros(wh.shape, jnp.float32)
    return jax.grad(f, argnums=tuple(range(6)))(*jin, h0), wy, wh


def _port_grads(case, wy, wh, dtype=torch.float64):
    tin, th0 = _torch(case)
    tin = [t.detach().to(dtype).requires_grad_(True) for t in tin]
    h0 = torch.from_numpy(case["h0"] if case["h0"] is not None
                          else np.zeros(wh.shape, np.float32))
    h0 = h0.to(dtype).requires_grad_(True)
    y, h = ssd_scan_plain(*tin, chunk=case["chunk"], h0=h0)
    loss = (y * torch.from_numpy(wy).to(dtype)).sum() + \
        (h * torch.from_numpy(wh).to(dtype)).sum()
    return torch.autograd.grad(loss, [*tin, h0]), tin, h0


GRAD_CASES = ("h0", "ragged_100", "ragged_33", "width")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_jax_where_finite(name):
    case = state_cases()[name]
    assert unmasked_exponent_max(case) < 80       # the reference is finite
    want, wy, wh = _jax_grads(case)
    got, _, _ = _port_grads(case, wy, wh, torch.float32)
    for arg, w, g in zip(NAMES + ("h0",), want, got):
        w = np.asarray(w)
        assert np.isfinite(w).all(), arg
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=arg)


def test_overflowing_chunk_reference_nan_port_finite_and_exact():
    """Documents the reference's NaN trap (its exp over the whole chunk
    square overflows above the diagonal): the JAX gradient is non-finite,
    the port's masked exponent gives finite gradients that match a float64
    central difference."""
    case = state_cases()["overflow"]
    assert unmasked_exponent_max(case) > 100
    want, wy, wh = _jax_grads(case)
    assert not all(np.isfinite(np.asarray(w)).all() for w in want)
    got, tin, h0 = _port_grads(case, wy, wh, torch.float64)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    wy64 = torch.from_numpy(wy).double()
    wh64 = torch.from_numpy(wh).double()

    def loss(args):
        y, h = ssd_scan_plain(*args[:5], chunk=case["chunk"], h0=args[5])
        return float((y * wy64).sum() + (h * wh64).sum())
    base = [t.detach().clone() for t in (*tin, h0)]
    rng = np.random.RandomState(3)
    eps = 1e-6
    for i, g in enumerate(got):
        for _ in range(3):
            idx = tuple(int(rng.randint(d)) for d in base[i].shape)
            up = [t.clone() for t in base]
            dn = [t.clone() for t in base]
            up[i][idx] += eps
            dn[i][idx] -= eps
            fd = (loss(up) - loss(dn)) / (2 * eps)
            assert abs(fd - float(g[idx])) <= 1e-5 * max(1.0, abs(fd)), \
                (NAMES[i] if i < 5 else "h0", idx, fd, float(g[idx]))


def test_wrapper_checks_shapes():
    case = kernel_case(*KERNEL_SHAPES[0])
    tin, _ = _torch(case)
    with pytest.raises(ValueError):
        ssd_scan(tin[0], tin[1][:, :-1], *tin[2:])
    with pytest.raises(ValueError):
        ssd_scan(*tin, h0=torch.zeros(1, 1, 1, 1))
    assert ssd.MAX_P >= 64 and ssd.MAX_N >= 128    # mamba2-130m's widths


# every case the backward's plain version is held to autograd on
BWD_CASES = {**{name: case for name, case in state_cases().items()},
             **{str(shape): kernel_case(*shape) for shape in KERNEL_SHAPES}}


@pytest.mark.parametrize("name", GRAD_CASES)
def test_bwd_plain_matches_jax_grad(name):
    case = state_cases()[name]
    assert unmasked_exponent_max(case) < 80       # the reference is finite
    want, wy, wh = _jax_grads(case)
    tin, th0 = _torch(case)
    h0 = th0 if th0 is not None else torch.zeros(wh.shape)
    got = ssd_scan_bwd_plain(*tin, torch.from_numpy(wy),
                             torch.from_numpy(wh), chunk=case["chunk"], h0=h0)
    for arg, w, g in zip(NAMES + ("h0",), want, got):
        w = np.asarray(w)
        assert np.isfinite(w).all(), arg
        assert g.dtype == torch.float32, arg
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4,
                                   err_msg=arg)


def _autograd_and_formula(case, dtype, use_gy=True, use_gh=True):
    """(autograd through ssd_scan_plain, ssd_scan_bwd_plain) for the
    cotangents drawn from a seed, each optional."""
    tin, th0 = _torch(case)
    tin = [t.detach().to(dtype).requires_grad_(True) for t in tin]
    b, _, h, p = case["x"].shape
    n = case["b"].shape[2]
    h0 = (torch.zeros((b, h, p, n)) if th0 is None else th0.detach())
    h0 = h0.to(dtype).requires_grad_(True)
    y, hf = ssd_scan_plain(*tin, chunk=case["chunk"], h0=h0)
    rng = np.random.RandomState(12)
    gy = torch.from_numpy(rng.randn(*y.shape)).to(dtype) if use_gy else None
    gh = torch.from_numpy(rng.randn(*hf.shape)).to(dtype) if use_gh else None
    pairs = [(o, g) for o, g in ((y, gy), (hf, gh)) if g is not None]
    want = torch.autograd.grad([o for o, _ in pairs], [*tin, h0],
                               [g for _, g in pairs], allow_unused=True)
    want = [torch.zeros_like(t) if w is None else w
            for w, t in zip(want, [*tin, h0])]
    got = ssd_scan_bwd_plain(*[t.detach() for t in tin], gy, gh,
                             chunk=case["chunk"], h0=h0.detach())
    return want, got


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_bwd_plain_matches_autograd(name, dtype, tol):
    case = BWD_CASES[name]
    want, got = _autograd_and_formula(case, dtype)
    for arg, w, g in zip(NAMES + ("h0",), want, got):
        assert bool(torch.isfinite(g).all()), arg
        assert g.dtype == w.dtype and g.shape == w.shape, arg
        torch.testing.assert_close(g, w, atol=tol, rtol=tol, msg=arg)


@pytest.mark.parametrize("present", ["gy", "g_hfin"])
@pytest.mark.parametrize("name", ["h0", "ragged_100"])
def test_bwd_plain_with_one_cotangent(name, present):
    want, got = _autograd_and_formula(state_cases()[name], torch.float64,
                                      use_gy=present == "gy",
                                      use_gh=present == "g_hfin")
    for arg, w, g in zip(NAMES + ("h0",), want, got):
        torch.testing.assert_close(g, w, atol=1e-10, rtol=1e-10, msg=arg)


def test_bwd_kernel_wrapper_needs_cuda():
    case = state_cases()["h0"]
    tin, th0 = _torch(case)
    before = ssd_scan.bwd_launches
    with pytest.raises(ValueError):
        ssd_scan_bwd(*tin, torch.zeros(case["x"].shape), None, h0=th0)
    assert ssd_scan.bwd_launches == before
