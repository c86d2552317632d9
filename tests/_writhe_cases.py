"""Writhe-map inputs shared by the port's CPU and card tests: trefoils,
random walks of 34-140 points and degenerate chains, all from numpy seeds.
Imports neither jax nor the port, so the card tests run where jax is absent.
"""
import numpy as np

ATOL, RTOL, SYM = 6e-4, 1e-3, 1e-4
# a structure's total writhe against float64, relative (chip_smoke.py's
# WR_REL); the card tests scale it by the ACN, the sum of the magnitudes
# whose round-off it collects, since a random walk's writhe may cancel to ~0
WR_REL = 3e-4


def trefoil(n=120, noise=0.0, seed=0):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = np.sin(t) + 2 * np.sin(2 * t)
    y = np.cos(t) - 2 * np.cos(2 * t)
    z = -np.sin(3 * t)
    pts = np.stack([x, y, z], -1)
    if noise:
        pts += np.random.RandomState(seed).randn(*pts.shape) * noise
    return pts


def walk(n, seed):
    rng = np.random.RandomState(seed)
    return np.cumsum(rng.randn(1, n, 3), 1)


def degenerate(kind):
    if kind == "repeated":   # zero-length segments inside a lattice walk
        # On a lattice the arithmetic is exact. Off it, two segments that
        # share an endpoint (either side of a repeated point) get a sign()
        # decided by round-off: 0 or ±0.25 in the reference, depending on
        # the order of operations, where the exact value is 0.
        steps = np.random.RandomState(9).randint(-1, 2, size=(60, 3))
        steps[::5] = 0
        return np.cumsum(steps, 0)[None].astype(float)
    if kind == "straight":   # every pair collinear
        return (np.arange(50)[:, None] * np.array([1.0, 2.0, -0.5]))[None]
    if kind == "point":      # one point repeated: all segments zero-length
        return np.ones((2, 12, 3))
    if kind == "planar":     # a zigzag in z = 0: sign() is 0 everywhere
        x = np.arange(30, dtype=float)
        return np.stack([x, x % 2, np.zeros_like(x)], -1)[None]
    if kind == "short":      # n < 3: the whole map is band
        return walk(2, 1)
    if kind == "empty":      # B = 0
        return np.zeros((0, 16, 3))
    raise ValueError(kind)


CASES = {
    "trefoil": lambda: np.stack([trefoil(100), trefoil(100, noise=0.05)]),
    **{f"walk{n}": (lambda n=n: walk(n, n % 6)) for n in (34, 61, 97, 140)},
    **{f"degenerate_{k}": (lambda k=k: degenerate(k))
       for k in ("repeated", "straight", "point", "planar", "short", "empty")},
}


# The reference's own round-off makes the noisy trefoil's map asymmetric by
# about 1.1e-4: (i, j) and (j, i) are evaluated in two operand orders.
ASYMMETRIC = {"trefoil"}


def check(got, want, case):
    """Kernel or plain map against its reference, at the tolerance of
    tests/test_kernels.py (near-planar pairs can round sign() to 0 in one
    order of operations), finite, and symmetric within SYM."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert np.isfinite(got).all()
    if case not in ASYMMETRIC:
        np.testing.assert_allclose(got, np.swapaxes(got, 1, 2), atol=SYM)
