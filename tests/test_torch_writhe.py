"""The port's writhe map against the JAX reference.

The plain PyTorch version (``writhe_map_ref``) is held to the reference's
``repro.kernels.ref.writhe_map_ref`` and to its Pallas kernel run in
interpret mode, at the tolerance ``tests/test_kernels.py`` uses (atol 6e-4,
rtol 1e-3: near-planar pairs can round sign() to 0 in one order of
operations) and with the map symmetric within 1e-4. The CUDA kernel is held
to the plain version on the card in ``tests/test_torch_writhe_cuda.py``;
here the CPU holds what the kernel shares with Python: the plain version of
its fused sums (``writhe_sums_ref``) against the reference's screen, its
tile-pair schedule (``block_tile``), and its asin polynomial, modelled in
float32 from the coefficients in ``csrc/writhe.cu``.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _writhe_cases import CASES, check, trefoil, walk
from repro.apps import knots as jknots
from repro.kernels import ref as jref
from repro.kernels.writhe import writhe_map as jwrithe_map
from repro_torch.apps import knots as tknots
from repro_torch.kernels import ops, writhe


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_ref(case):
    coords = CASES[case]().astype(np.float32)
    got = writhe.writhe_map_ref(torch.from_numpy(coords)).numpy()
    want = np.asarray(jref.writhe_map_ref(jnp.asarray(coords)))
    check(got, want, case)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c not in ("degenerate_empty",
                                                     "degenerate_short")))
def test_plain_matches_pallas_interpret(case):
    coords = CASES[case]().astype(np.float32)
    got = writhe.writhe_map_ref(torch.from_numpy(coords)).numpy()
    want = np.asarray(jwrithe_map(jnp.asarray(coords), block=32,
                                  interpret=True))
    check(got, want, case)


def test_trefoil_writhe_value():
    """A closed trefoil's writhe is about ±3.41; an open walk is near 0."""
    w = writhe.writhe_map_ref(torch.tensor(trefoil(160)[None],
                                           dtype=torch.float32))
    assert 2.8 < abs(float(w.sum()) / 2.0) < 4.0
    coil = torch.tensor(np.cumsum(np.random.RandomState(3).randn(1, 160, 3)
                                  * 0.5, 1), dtype=torch.float32)
    assert abs(float(writhe.writhe_map_ref(coil).sum()) / 2.0) < 1.5


def test_cpu_tensor_takes_plain_version_without_launch():
    before = writhe.writhe_map.launches
    coords = torch.from_numpy(walk(40, 2).astype(np.float32))
    want = writhe.writhe_map_ref(coords)
    assert torch.equal(ops.writhe(coords), want)
    assert torch.equal(ops.writhe(coords, use_pallas=True), want)
    assert torch.equal(writhe.writhe_map(coords), want)
    assert writhe.writhe_map.launches == before
    if not torch.cuda.is_available():
        assert before == 0


def test_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        writhe.writhe_map(torch.zeros(4, 3))
    with pytest.raises(ValueError):
        writhe.writhe_map(torch.zeros(1, 5, 2))


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tknots._screen_batch(list(range(8)), 32, False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tknots._localize_cores([0], 32, False, lambda: None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sums_ref_matches_jax_writhe_and_acn(case):
    coords = CASES[case]().astype(np.float32)
    wr, acn, w = writhe.writhe_sums_ref(torch.from_numpy(coords))
    jwr, jacn, _ = jknots.writhe_and_acn(jnp.asarray(coords))
    assert wr.shape == acn.shape == (coords.shape[0],)
    np.testing.assert_allclose(wr.numpy(), np.asarray(jwr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(acn.numpy(), np.asarray(jacn), rtol=1e-4)
    assert torch.equal(w, writhe.writhe_map_ref(torch.from_numpy(coords)))


def test_block_schedule_covers_each_tile_pair_once():
    """Every (ti <= tj) tile pair of every structure exactly once, row-major
    over the upper triangle, the batch folded in as the kernel folds it."""
    for tiles in range(1, 65):
        for batch in (1, 3):
            pairs = tiles * (tiles + 1) // 2
            got = [writhe.block_tile(blk, tiles)
                   for blk in range(batch * pairs)]
            want = [(b, ti, tj) for b in range(batch)
                    for ti in range(tiles) for tj in range(ti, tiles)]
            assert got == want, (tiles, batch)


@pytest.mark.parametrize("tiles", [100, 1000, 4096, 23170])
def test_block_schedule_exact_at_row_boundaries(tiles):
    """The float32 root is corrected to the exact row where float32 cannot
    tell neighbouring rows apart: the first and last block of rows spread
    over the whole triangle."""
    pairs = tiles * (tiles + 1) // 2
    for ti in sorted({0, 1, 2, tiles // 3, tiles // 2, tiles - 2,
                      tiles - 1} | set(range(0, tiles, max(tiles // 97, 1)))):
        first = ti * tiles - ti * (ti - 1) // 2
        assert writhe.block_tile(first, tiles) == (0, ti, ti)
        last = first + tiles - ti - 1
        assert writhe.block_tile(last, tiles) == (0, ti, tiles - 1)
        assert writhe.block_tile(2 * pairs + last, tiles) == (2, ti, tiles - 1)


def test_cpu_writhe_and_acn_launches_nothing():
    """On the CPU the screen's sums are the plain map's, summed as before;
    no kernel is launched."""
    before = writhe.writhe_map.launches
    coords = torch.from_numpy(walk(40, 2).astype(np.float32))
    wr, acn, w = tknots.writhe_and_acn(coords)
    want_w = writhe.writhe_map_ref(coords)
    assert torch.equal(w, want_w)
    assert torch.equal(wr, want_w.sum(dim=(1, 2)) / 2.0)
    assert torch.equal(acn, torch.abs(want_w).sum(dim=(1, 2)) / 2.0)
    for got, want in zip(writhe.writhe_map_sums(coords),
                         writhe.writhe_sums_ref(coords)):
        assert torch.equal(got, want)
    assert writhe.writhe_map.launches == before


def test_sums_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError):
        writhe.writhe_map_sums(torch.zeros(4, 3))
    with pytest.raises(ValueError):
        writhe.writhe_map_sums(torch.zeros(1, 5, 2))


KERNEL_SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
                 / "kernels" / "csrc" / "writhe.cu")
APPROX_REL = 2.0 ** -22     # sqrt.approx, relative


def source_constants() -> dict[str, float]:
    """The ``constexpr float`` constants of csrc/writhe.cu, by name."""
    pat = r"constexpr float (\w+) = ([-+0-9.e]+)f;"
    return {k: float(v) for k, v in re.findall(pat, KERNEL_SOURCE.read_text())}


def fma(a, b, c):
    """float32 fused multiply-add: the float64 product is exact."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def asin_clip(x, rng=None):
    """The kernel's ``asin_clip`` in float32; ``rng`` draws sqrt.approx's
    error within its bound (None: a correctly rounded square root)."""
    f32 = np.float32
    k = source_constants()
    c = [f32(k[f"ASIN_C{i}"]) for i in range(5)]
    x = np.asarray(x, f32)
    a = np.minimum(np.abs(x), f32(1))
    big = a > f32(0.5)
    tb = fma(f32(-0.5), a, f32(0.5))
    t = np.where(big, tb, (a * a).astype(f32))
    root = np.sqrt(tb.astype(np.float64)).astype(f32)
    if rng is not None:
        root = (root * (1 + rng.uniform(-APPROX_REL, APPROX_REL, root.shape))
                ).astype(f32)
    s = np.where(big, root, a)
    p = fma(fma(fma(fma(c[4], t, c[3]), t, c[2]), t, c[1]), t, c[0])
    r = fma((s * t).astype(f32), p, s)
    rb = (fma(f32(-2), r, f32(k["PIO2_HI"])) + f32(k["PIO2_LO"])).astype(f32)
    return np.copysign(np.where(big, rb, r), x).astype(f32)


def _asin_inputs() -> np.ndarray:
    """Every float32 in [1/2, 1] and 8e6 samples of [0, 1/2), both signs."""
    lo, hi = np.float32(0.5).view(np.int32), np.float32(1.0).view(np.int32)
    top = np.arange(lo, hi + 1, dtype=np.int32).view(np.float32)
    below = np.random.RandomState(0).uniform(0, 0.5, 8_000_000)
    x = np.concatenate([top, below.astype(np.float32)])
    return np.concatenate([x, -x[::5]])


def test_asin_polynomial_error():
    """The kernel's asin (coefficients parsed from csrc/writhe.cu) against
    float64 asin, evaluated in float32: the bounds its note states, with an
    exact square root and with sqrt.approx's 2^-22 error drawn at random."""
    x = _asin_inputs()
    exact = np.arcsin(x.astype(np.float64))
    err = np.abs(asin_clip(x).astype(np.float64) - exact).max()
    err_approx = np.abs(asin_clip(x, np.random.default_rng(0))
                        .astype(np.float64) - exact).max()
    assert err <= 1.7e-7, err
    assert err_approx <= 3.9e-7, err_approx
    # the clip: beyond +-1 the value is asin(+-1)
    np.testing.assert_array_equal(
        asin_clip(np.array([1.5, -1.0001, 1.0], np.float32)),
        np.float32([np.pi / 2, -np.pi / 2, np.pi / 2]))
