"""The CUDA writhe kernel against its plain PyTorch version, on the card.

Marked ``cuda``: it skips where no CUDA device is present. It imports no jax,
so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_writhe_cuda.py``.
"""
import numpy as np
import pytest
import torch

from _writhe_cases import CASES, check
from repro_torch.kernels import writhe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, cuda_device):
    coords = torch.from_numpy(CASES[case]().astype(np.float32))
    before = writhe.writhe_map.launches
    got = writhe.writhe_map(coords.to(cuda_device))
    torch.cuda.synchronize()
    want = writhe.writhe_map_ref(coords.to(cuda_device))
    got = got.cpu().numpy()
    check(got, want.cpu().numpy(), case)
    # the kernel evaluates each pair in one order: exactly symmetric
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))
    launched = coords.shape[0] > 0 and coords.shape[1] >= 3
    assert writhe.writhe_map.launches == before + int(launched)
