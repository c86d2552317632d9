"""The port's writhe map against the JAX reference.

The plain PyTorch version (``writhe_map_ref``) is held to the reference's
``repro.kernels.ref.writhe_map_ref`` and to its Pallas kernel run in
interpret mode, at the tolerance ``tests/test_kernels.py`` uses (atol 6e-4,
rtol 1e-3: near-planar pairs can round sign() to 0 in one order of
operations) and with the map symmetric within 1e-4. The CUDA kernel is held
to the plain version on the card in ``tests/test_torch_writhe_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _writhe_cases import CASES, check, trefoil, walk
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
