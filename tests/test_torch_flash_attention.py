"""The port's flash attention (plain version and wrapper) against the JAX
package, on the CPU.

* ``flash_attention_plain`` (the model's ``chunked_attention``) against the
  Pallas kernel ``repro.kernels.flash_attention.flash_attention`` in
  interpret mode and against ``repro.kernels.ref.attention_ref`` on every
  case of ``tests/test_kernels.py`` (f32 atol/rtol 2e-5, bf16 2e-2), the
  bidirectional case, points of the property sweep (3e-5), and queries
  with ``q_offset > 0``.
* At the model's ``kv_chunk`` (the banded path for local layers) it is the
  model's ``chunked_attention`` exactly, and equals JAX's within 2e-5; its
  gradients equal ``jax.grad`` of the reference's within 1e-5.
* The plain versions beside the kernels' other outputs:
  ``flash_attention_lse_plain`` equals ``jax.nn.logsumexp`` of the
  reference's masked scores, and ``flash_attention_bwd_plain`` equals
  ``jax.grad`` of the reference's ``chunked_attention`` (causal, window 40,
  bidirectional, GQA, ragged Sk, q_offset; 1e-5 in float32); rows with no
  valid key get lse -inf and zero gradients.
* On a CPU tensor the wrappers take the plain versions and launch
  nothing; the default device of the training entry points asks for CUDA
  and raises without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _flash_attention_cases import (ATOL_BF16, ATOL_F32, KERNEL_SHAPES,
                                    empty_rows_case, kernel_case,
                                    kernel_cases, offset_cases, random_case)
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import chunked_attention as jax_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models.attention import chunked_attention

DTYPES = {"float32": (jnp.float32, torch.float32, ATOL_F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, ATOL_BF16)}


def _jax_in(case, dtype=jnp.float32):
    return [jnp.asarray(case[n], dtype) for n in ("q", "k", "v")]


def _torch_in(case, dtype=torch.float32, grad=False):
    return [torch.from_numpy(case[n]).to(dtype).requires_grad_(grad)
            for n in ("q", "k", "v")]


def _kw(case):
    return dict(causal=case["causal"], window=case["window"],
                q_offset=case["q_offset"])


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX results, each built once for the module: the Pallas kernel in
    interpret mode and the reference (chunked_attention in one key chunk,
    ``attention_ref``'s call, with the case's q_offset)."""
    memo = {}

    def get(name, case, dtype_name="float32"):
        key = (name, dtype_name)
        if key not in memo:
            jdt = DTYPES[dtype_name][0]
            q, k, v = _jax_in(case, jdt)
            pallas = jax_flash(q, k, v, interpret=True, **_kw(case))
            want = jax_chunked(*_jax_in(case), kv_chunk=case["k"].shape[1],
                               **_kw(case))
            memo[key] = (np.asarray(pallas, np.float32),
                         np.asarray(want, np.float32))
        return memo[key]
    return get


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_plain_matches_pallas_interpret_and_ref(shape, dtype, jax_outputs):
    case = kernel_case(*shape)
    jdt, tdt, tol = DTYPES[dtype]
    pallas, want = jax_outputs(str(shape), case, dtype)
    # attention_ref itself, on the float32 inputs of tests/test_kernels.py
    ref = jax_ref.attention_ref(*_jax_in(case), causal=True,
                                window=case["window"])
    np.testing.assert_allclose(want, np.asarray(ref), atol=0, rtol=0)
    got = ops.attention(*_torch_in(case, tdt), causal=True,
                        window=case["window"])
    assert got.dtype == tdt and got.shape == case["q"].shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", [n for n in kernel_cases()
                                  if not n.startswith("kernel_")])
def test_plain_matches_jax_other_cases(name, jax_outputs):
    """The bidirectional case, points of the property sweep and queries
    continuing a prefix (q_offset > 0)."""
    case = kernel_cases()[name]
    pallas, want = jax_outputs(name, case)
    got = fa.flash_attention_plain(*_torch_in(case),
                                   kv_chunk=case["k"].shape[1],
                                   **_kw(case)).numpy()
    tol = case["tol"]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)


def test_offset_cases_reach_past_every_tile():
    """The offset cases hold Sq < Sk, positions that start mid-tile and a
    group size that is not a power of two."""
    cases = offset_cases()
    assert all(c["q_offset"] > 0 and c["q"].shape[1] < c["k"].shape[1]
               for c in cases.values())
    assert cases["offset_window"]["q"].shape[2] // \
        cases["offset_window"]["k"].shape[2] == 3


@pytest.mark.parametrize("window", [None, 96])
def test_plain_at_model_chunk_is_chunked_attention(window):
    """At the model's kv_chunk (64 in the smoke configs; S = 256 takes the
    banded path with a window) the plain version is the model's
    chunked_attention, and equals JAX's within 2e-5."""
    case = random_case(21, 2, 256, 256, 4, 2, 32, window=window)
    q, k, v = _torch_in(case)
    got = fa.flash_attention_plain(q, k, v, window=window, kv_chunk=64)
    assert torch.equal(got, chunked_attention(q, k, v, window=window,
                                              kv_chunk=64))
    assert torch.equal(got, fa.flash_attention(q, k, v, window=window,
                                               kv_chunk=64))
    want = jax_chunked(*_jax_in(case), window=window, kv_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32,
                               rtol=ATOL_F32)


def test_empty_rows_follow_the_reference_on_the_cpu():
    """Queries with no valid key: the plain version (like the reference)
    averages over masked keys; the kernel's zeros are checked on the card."""
    case, empty = empty_rows_case()
    got = fa.flash_attention_plain(*_torch_in(case), window=case["window"],
                                   kv_chunk=16).numpy()
    want = np.asarray(jax_chunked(*_jax_in(case), window=case["window"],
                                  kv_chunk=16))
    np.testing.assert_allclose(got, want, atol=ATOL_F32, rtol=ATOL_F32)
    assert np.abs(got[:, empty]).max() > 0


@pytest.mark.parametrize("window", [None, 40])
def test_gradients_match_jax(window):
    """On a CPU tensor the wrapper trains by autograd through the plain
    version: its gradients equal jax.grad of the reference's
    chunked_attention (1e-5)."""
    case = random_case(22, 2, 96, 96, 6, 2, 32, window=window)
    w = np.random.RandomState(3).randn(*case["q"].shape).astype(np.float32)
    q, k, v = _torch_in(case, grad=True)
    out = fa.flash_attention(q, k, v, window=window, kv_chunk=32)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (q, k, v))

    def loss(q, k, v):
        o = jax_chunked(q, k, v, window=window, kv_chunk=32)
        return (o * jnp.asarray(w)).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax_in(case))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=1e-5,
                                   rtol=1e-5)


def _jax_lse(case):
    """jax.nn.logsumexp of the reference's masked scaled scores, (B, H,
    Sq); -inf where a row has no valid key."""
    q, k, _ = _jax_in(case)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    s = jnp.einsum("bqkgd,bckd->bqkgc", q.reshape(b, sq, kh, h // kh, d),
                   k) * (1.0 / np.sqrt(d))
    qp = case["q_offset"] + jnp.arange(sq)[:, None]
    kp = jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)
    if case["causal"]:
        mask &= kp <= qp
    if case["window"] is not None:
        mask &= kp > qp - case["window"]
    s = jnp.where(mask[None, :, None, None, :], s, -jnp.inf)
    lse = jax.nn.logsumexp(s, axis=-1).reshape(b, sq, h)
    return np.asarray(lse.transpose(0, 2, 1))


# the backward's cases: tests/test_kernels.py's causal, window 40,
# bidirectional, GQA (H = 6 on K = 2), a ragged Sk and q_offset
GRAD_CASES = {
    "causal": dict(args=(41, 2, 96, 96, 4, 2, 32)),
    "window_40": dict(args=(42, 2, 96, 96, 6, 2, 32), window=40),
    "bidirectional": dict(args=(43, 1, 80, 80, 4, 4, 64), causal=False),
    "gqa_h6_k2": dict(args=(44, 1, 64, 64, 6, 2, 16)),
    "ragged_sk": dict(args=(45, 2, 48, 130, 4, 2, 64), q_offset=82),
    "ragged_sk_window": dict(args=(46, 1, 40, 100, 6, 2, 32), window=24,
                             q_offset=60),
    "kernel_d80": dict(args=(47, 1, 70, 70, 4, 4, 80)),
}


def _grad_case(name):
    spec = dict(GRAD_CASES[name])
    return random_case(*spec.pop("args"), **spec)


@pytest.mark.parametrize("name", sorted(kernel_cases()))
def test_lse_plain_matches_jax(name):
    case = kernel_cases()[name]
    got = fa.flash_attention_lse_plain(*_torch_in(case)[:2], **_kw(case),
                                       kv_chunk=64)
    assert got.shape == (case["q"].shape[0], case["q"].shape[2],
                         case["q"].shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_lse(case), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_bwd_plain_matches_jax_grad(name):
    """The backward's plain version, given the plain forward's out and lse
    and the output gradient g, equals jax.grad of the reference's
    chunked_attention through sum(out * g), in float32 (1e-5)."""
    case = _grad_case(name)
    g = np.random.RandomState(5).randn(*case["q"].shape).astype(np.float32)
    q, k, v = _torch_in(case)
    out = fa.flash_attention_plain(q, k, v, **_kw(case))
    lse = fa.flash_attention_lse_plain(q, k, **_kw(case))
    got = fa.flash_attention_bwd_plain(q, k, v, out, lse, torch.from_numpy(g),
                                       **_kw(case), kv_chunk=32)

    def loss(q, k, v):
        o = jax_chunked(q, k, v, kv_chunk=32, **_kw(case))
        return (o * jnp.asarray(g)).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(*_jax_in(case))
    for t, w in zip(got, want):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_rows_without_keys_get_zero_gradients():
    """Rows with no valid key: lse -inf, zero dq, and nothing in dk or dv
    (the same as with their output gradient zeroed)."""
    case, empty = empty_rows_case()
    q, k, v = _torch_in(case)
    lse = fa.flash_attention_lse_plain(q, k, **_kw(case))
    assert bool((lse[:, :, empty] == -np.inf).all())
    assert bool(torch.isfinite(lse[:, :, :empty[0]]).all())
    out = fa.flash_attention_plain(q, k, v, **_kw(case))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                              **_kw(case))
    assert bool((dq[:, empty] == 0).all())
    g0 = g.clone()
    g0[:, empty] = 0
    _, dk0, dv0 = fa.flash_attention_bwd_plain(q, k, v, out, lse, g0,
                                               **_kw(case))
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)


def test_bwd_plain_takes_the_inputs_dtype():
    case = _grad_case("gqa_h6_k2")
    q, k, v = _torch_in(case, torch.bfloat16)
    out, lse = fa.flash_attention_forward(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    grads = fa.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(q))
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert [t.shape for t in grads] == [q.shape, k.shape, v.shape]


def test_cpu_tensor_takes_plain_version_without_launch():
    before = fa.flash_attention.launches, fa.flash_attention.bwd_launches
    case = kernel_case(*KERNEL_SHAPES[1])
    q, k, v = _torch_in(case)
    want = fa.flash_attention_plain(q, k, v, window=96, kv_chunk=256)
    assert torch.equal(fa.flash_attention(q, k, v, window=96, kv_chunk=256),
                       want)
    assert torch.equal(ops.attention(q, k, v, window=96, use_pallas=True),
                       want)
    bf = fa.flash_attention(q, k, v, window=96, score_dtype=torch.bfloat16)
    assert bf.shape == q.shape and bool(torch.isfinite(bf).all())
    out, lse = fa.flash_attention_forward(q, k, v, window=96, kv_chunk=256)
    assert torch.equal(out, want)
    assert torch.equal(lse, fa.flash_attention_lse_plain(q, k, window=96,
                                                         kv_chunk=256))
    g = torch.ones_like(q)
    for t, w in zip(fa.flash_attention_bwd(q, k, v, out, lse, g, window=96),
                    fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                 window=96)):
        assert torch.equal(t, w)
    assert (fa.flash_attention.launches,
            fa.flash_attention.bwd_launches) == before
    if not torch.cuda.is_available():
        assert before == (0, 0)


def test_wrapper_checks_shapes_and_devices():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, kv[..., :8], kv)
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q[0], kv[0], kv[0])
    # meta tensors (shapes only, what the dry-run counts operations on)
    # take the plain version and launch nothing
    before = (fa.flash_attention.launches, fa.flash_attention.bwd_launches)
    out = fa.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert (fa.flash_attention.launches,
            fa.flash_attention.bwd_launches) == before
    assert {64, 80, 256} <= set(fa.HEAD_DIMS)    # stablelm, hubert, gemma3


def test_default_device_raises_without_cuda():
    """The training entry points default to the card; without one they
    raise instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs")
    from repro_torch import configs
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import init_train_state
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(configs.smoke_config("gemma3_1b"), OptimizerConfig(),
                         torch.Generator().manual_seed(0))


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_forward_design_follows_dtype_and_head_dim(dtype, d, aligned):
    """The forward's design is chosen from dtype and D alone: bf16 with
    D <= 128 takes the Hopper design, bf16 at D = 256 mma.sync, float32
    and the ``fma`` flag the FMA design. For the Hopper design an input
    that TMA cannot read (a base off 16 bytes, rows of D + 1) is copied
    into a contiguous tensor; every other input is read in place."""
    if aligned:
        q = torch.randn(2, 8, 4, d, dtype=dtype)
    else:
        q = torch.randn(2, 8, 4, d + 1, dtype=dtype)[..., 1:]
    want = ("fma" if dtype == torch.float32
            else "wgmma" if d <= 128 else "mma")
    assert fa._forward_design(q) == want
    assert fa._forward_design(q, fma=True) == "fma"
    tma = want == "wgmma"
    got = fa._prepare(q, q, q, 0, tma=tma)
    assert all(torch.equal(t, q) for t in got)
    assert fa._tma_ok(q) == aligned
    copied = got[0].data_ptr() != q.data_ptr()
    assert copied == (tma and not aligned)
    if tma:
        assert all(fa._tma_ok(t) for t in got)
