"""Flash-attention inputs shared by the port's CPU tests, its card tests and
``chip_smoke.py``. All from numpy seeds; imports neither jax nor the port,
so the card tests and the smoke script run where jax is absent.

A case is a dict of numpy float32 arrays ``q`` (B, Sq, H, D), ``k`` and
``v`` (B, Sk, K, D), with ``causal``, ``window``, ``q_offset`` and the
tolerance ``tol`` of its float32 comparison.
"""
import numpy as np

ATOL_F32, ATOL_BF16 = 2e-5, 2e-2      # tests/test_kernels.py
SWEEP_ATOL = 3e-5                     # its property sweep

# (sq, h, kh, d, win): the cases of
# tests/test_kernels.py::test_flash_attention_vs_ref (block sizes dropped)
KERNEL_SHAPES = [
    (256, 4, 2, 64, None),
    (256, 4, 1, 64, 96),
    (192, 2, 2, 32, None),
    (128, 8, 4, 128, 32),
    (320, 4, 4, 80, None),   # hubert-style head_dim 80
    (130, 4, 2, 64, None),   # ragged seq (padding path)
]

# (sq, g, kh, d, win): points of tests/test_kernels.py::
# test_flash_attention_property_sweep's space (sq 64..512, g 1/2/4, kh 1/2,
# d 32/64, window None/64/130)
SWEEP_POINTS = [
    (64, 1, 1, 32, None),
    (128, 2, 1, 64, 64),
    (256, 4, 2, 32, 130),
    (512, 2, 2, 64, 64),
    (128, 4, 1, 64, 130),
    (512, 1, 2, 32, None),
]

# Whole-sequence attention at the widths of the models whose training or
# encoder forward runs the kernel: gemma3-1b's global and local (window
# 512) layers at the train_4k sequence and the training main path's batch
# of two sequences, stablelm-1.6b (MHA, D 64), hubert-xlarge
# (bidirectional, D 80) and internvl2-1b (G 7).
MODEL_SHAPES = {
    "gemma3_1b_global": dict(b=2, s=4096, h=4, kh=1, d=256, causal=True,
                             window=None),
    "gemma3_1b_local": dict(b=2, s=4096, h=4, kh=1, d=256, causal=True,
                            window=512),
    "stablelm_1_6b": dict(b=2, s=4096, h=32, kh=32, d=64, causal=True,
                          window=None),
    "hubert_xlarge": dict(b=2, s=1024, h=16, kh=16, d=80, causal=False,
                          window=None),
    "internvl2_1b": dict(b=2, s=1024, h=14, kh=2, d=64, causal=True,
                         window=None),
}

# hubert-xlarge's encoder forward at the prefill_32k sequence (its batch
# cut from 32 to 1): checked forward only, in bf16 against the plain
# version in float32, as no dense float64 reference fits at this length
LONG_SHAPES = {
    "hubert_xlarge_32k": dict(b=1, s=32768, h=16, kh=16, d=80, causal=False,
                              window=None),
}


def kernel_case(sq, h, kh, d, win):
    """Exactly the inputs of tests/test_kernels.py for this shape (float32;
    a bf16 test rounds them)."""
    rng = np.random.RandomState(hash((sq, h, d)) % 2**31)
    return {"q": rng.randn(2, sq, h, d).astype(np.float32),
            "k": rng.randn(2, sq, kh, d).astype(np.float32),
            "v": rng.randn(2, sq, kh, d).astype(np.float32),
            "causal": True, "window": win, "q_offset": 0, "tol": ATOL_F32}


def bidirectional_case():
    """tests/test_kernels.py::test_flash_attention_bidirectional."""
    rng = np.random.RandomState(7)
    return {"q": rng.randn(1, 128, 4, 64).astype(np.float32),
            "k": rng.randn(1, 128, 4, 64).astype(np.float32),
            "v": rng.randn(1, 128, 4, 64).astype(np.float32),
            "causal": False, "window": None, "q_offset": 0, "tol": ATOL_F32}


def sweep_case(sq, g, kh, d, win):
    """One point of the property sweep, with its inputs."""
    h = g * kh
    rng = np.random.RandomState(sq * h + d)
    return {"q": rng.randn(1, sq, h, d).astype(np.float32),
            "k": rng.randn(1, sq, kh, d).astype(np.float32),
            "v": rng.randn(1, sq, kh, d).astype(np.float32),
            "causal": True, "window": win, "q_offset": 0, "tol": SWEEP_ATOL}


def random_case(seed, b, sq, sk, h, kh, d, *, causal=True, window=None,
                q_offset=0):
    rng = np.random.RandomState(seed)
    return {"q": rng.randn(b, sq, h, d).astype(np.float32),
            "k": rng.randn(b, sk, kh, d).astype(np.float32),
            "v": rng.randn(b, sk, kh, d).astype(np.float32),
            "causal": causal, "window": window, "q_offset": q_offset,
            "tol": ATOL_F32}


def offset_cases():
    """Queries that continue a prefix (q_offset > 0, Sq < Sk, ragged
    against every tile size), with and without a window, and G = 3."""
    return {
        "offset": random_case(11, 2, 48, 160, 4, 2, 64, q_offset=112),
        "offset_window": random_case(12, 1, 40, 100, 6, 2, 32, window=24,
                                     q_offset=60),
        "offset_bidirectional": random_case(13, 2, 33, 70, 4, 4, 16,
                                            causal=False, q_offset=5),
    }


def empty_rows_case():
    """Queries past the last key by more than the window have no valid key
    (positions >= Sk + window - 1); the kernel's contract is zeros there,
    chunked_attention's is an average over masked keys. Returns the case
    and the query positions whose rows must be zero."""
    case = random_case(14, 2, 64, 16, 4, 1, 64, window=8)
    return case, list(range(16 + 8 - 1, 64))


def kernel_cases():
    """Every case the kernel is held to against its plain version, by
    name: tests/test_kernels.py's, the bidirectional one, the sweep points
    and the offset ones."""
    out = {f"kernel_{s}": kernel_case(*s) for s in KERNEL_SHAPES}
    out["bidirectional"] = bidirectional_case()
    out.update({f"sweep_{p}": sweep_case(*p) for p in SWEEP_POINTS})
    out.update(offset_cases())
    return out
