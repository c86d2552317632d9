"""SSD-scan inputs shared by the port's CPU tests, its card tests and
``chip_smoke.py``. All from numpy seeds; imports neither jax nor the port,
so the card tests and the smoke script run where jax is absent.

A case is a dict of numpy arrays ``x`` (B, S, H, P), ``dt`` (B, S, H)
(post-softplus, >= 0), ``a`` (H,) (negative), ``b`` and ``c`` (B, S, N), and
``h0`` (B, H, P, N) or None, with ``chunk`` (the model's chunk; the CUDA
kernels' own is 64 steps).
"""
import numpy as np

ATOL_F32, ATOL_BF16 = 1e-4, 5e-2      # tests/test_kernels.py

# (S, H, P, N, chunk): the cases of tests/test_kernels.py::test_ssd_kernel_vs_ref
KERNEL_SHAPES = [(256, 2, 32, 16, 64), (128, 4, 64, 128, 32),
                 (512, 1, 16, 8, 128)]

# mamba2-130m's training shape: batch 8 x 2048 tokens, 24 heads of 64, N 128
MAIN_SHAPE = dict(b=8, s=2048, h=24, p=64, n=128, chunk=256)

# the backward kernel in bf16 against its plain version in float32 on the
# same bf16 inputs, per output: ||kernel - plain|| / ||plain||. Rounding
# dx, dB and dC to bf16 alone costs about 1e-3 (half an ulp at 2^-8,
# spread evenly), and the kernel rounds the operands it computes (M, the
# summed dCB, the states and adjoints) to bf16 for the tensor cores, each
# another term of that order
BWD_REL_BF16 = 1e-2


def kernel_case(s, h, p, n, chunk):
    """Exactly the inputs of tests/test_kernels.py for this shape."""
    rng = np.random.RandomState(s + h)
    return {"x": rng.randn(2, s, h, p).astype(np.float32),
            "dt": (np.abs(rng.randn(2, s, h)) * 0.1).astype(np.float32),
            "a": (-(np.abs(rng.randn(h)) + 0.5)).astype(np.float32),
            "b": rng.randn(2, s, n).astype(np.float32),
            "c": rng.randn(2, s, n).astype(np.float32),
            "h0": None, "chunk": chunk}


def random_case(seed, b, s, h, p, n, chunk, *, h0=False, dt_scale=0.1,
                a_scale=1.0):
    rng = np.random.RandomState(seed)
    out = {"x": rng.randn(b, s, h, p).astype(np.float32),
           "dt": (np.abs(rng.randn(b, s, h)) * dt_scale).astype(np.float32),
           "a": (-(np.abs(rng.randn(h)) + 0.5) * a_scale).astype(np.float32),
           "b": (rng.randn(b, s, n) * 0.5).astype(np.float32),
           "c": (rng.randn(b, s, n) * 0.5).astype(np.float32),
           "h0": None, "chunk": chunk}
    if h0:
        out["h0"] = rng.randn(b, h, p, n).astype(np.float32)
    return out


def state_cases():
    """h0 and the final state, ragged lengths, and a chunk whose unmasked
    exponent overflows (dt * |a| summed over a chunk far above 100, so
    exp(cum_i - cum_j) above the diagonal is inf in float32)."""
    return {
        "h0": random_case(1, 2, 96, 3, 16, 8, 32, h0=True),
        "ragged_100": random_case(2, 2, 100, 2, 32, 16, 32, h0=True),
        "ragged_33": random_case(3, 1, 33, 2, 16, 16, 32),
        "one_step": random_case(4, 2, 1, 2, 16, 8, 32, h0=True),
        "overflow": random_case(5, 1, 64, 2, 16, 8, 64, dt_scale=2.0,
                                a_scale=4.0),
        "width": random_case(6, 2, 80, 3, 64, 128, 64, h0=True),
        # widths that are not multiples of 8: the kernels' element-wise
        # loads and their one-entry-a-thread pass over the state
        "odd_width": random_case(7, 2, 70, 2, 10, 6, 32, h0=True),
    }


def unmasked_exponent_max(case):
    """The largest exponent cum_i - cum_j over the whole chunk square, as
    the reference forms it (float64)."""
    la = case["dt"].astype(np.float64) * case["a"].astype(np.float64)
    s, c = la.shape[1], case["chunk"]
    worst = -np.inf
    for z in range(0, s, c):
        cum = np.cumsum(la[:, z:z + c], axis=1)
        worst = max(worst, float((cum[:, None] - cum[:, :, None]).max()))
    return worst
