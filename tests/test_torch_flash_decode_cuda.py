"""The CUDA flash-decode kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: they skip where no CUDA device is present. The file imports
no jax, so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_decode_cuda.py``.
"""
import numpy as np
import pytest
import torch

from _flash_decode_cases import (ATOL_BF16, ATOL_F32, CASES, MAIN_PATH,
                                 main_path_cases, oracle)
from repro_torch.kernels import flash_decode as fd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def run(case, device, dtype, fn=None):
    """The case through ``fn`` (the dispatching wrapper by default) on
    ``device`` in ``dtype``; positions and tables stay int32."""
    t = {n: torch.from_numpy(case[n]).to(device, dtype)
         for n in ("q", "k", "v")}
    qpos = torch.from_numpy(case["qpos"]).to(device)
    if case["kind"] == "paged":
        fn = fn or fd.flash_decode_paged
        return fn(t["q"], t["k"], t["v"], qpos,
                  torch.from_numpy(case["table"]).to(device),
                  window=case["window"])
    fn = fn or fd.flash_decode
    return fn(t["q"], t["k"], t["v"], qpos,
              torch.from_numpy(case["kpos"]).to(device),
              window=case["window"], bounded=case["bounded"])


def plain(case):
    return fd.flash_decode_paged_ref if case["kind"] == "paged" \
        else fd.flash_decode_ref


def launches(case):
    fn = fd.flash_decode_paged if case["kind"] == "paged" else fd.flash_decode
    return fn.launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_f32(name, cuda_device):
    case = CASES[name]()
    before = launches(case)
    got = run(case, cuda_device, torch.float32)
    torch.cuda.synchronize()
    assert launches(case) == before + 1
    want = run(case, cuda_device, torch.float32, plain(case))
    assert got.dtype == torch.float32
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want.cpu().numpy(), atol=ATOL_F32)
    np.testing.assert_allclose(got, oracle(case), atol=ATOL_F32)
    for lane in case["empty"]:
        np.testing.assert_array_equal(got[lane], 0.0)   # exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("name", MAIN_PATH)
def test_kernel_matches_plain_bf16_main_path(name, cuda_device):
    """The serving main path's shapes in bf16, against the plain version in
    float32 on the same bf16 inputs."""
    case = main_path_cases()[name]
    got = run(case, cuda_device, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    t = {n: torch.from_numpy(case[n]).to(cuda_device, torch.bfloat16).float()
         for n in ("q", "k", "v")}
    bf = dict(case, **{n: t[n].cpu().numpy() for n in t})
    want = run(bf, cuda_device, torch.float32, plain(case))
    torch.testing.assert_close(got.float(), want, atol=ATOL_BF16,
                               rtol=ATOL_BF16)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 1, 16, 64, device=cuda_device)
    k = torch.zeros(2, 32, 1, 64, device=cuda_device)       # G = 16 > 8
    pos = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, k, pos)
    q = torch.zeros(2, 1, 1, 320, device=cuda_device)       # D = 320 > 256
    k = torch.zeros(2, 32, 1, 320, device=cuda_device)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, k, pos)
    q = torch.zeros(2, 1, 2, 64, device=cuda_device, dtype=torch.float16)
    k = torch.zeros(2, 32, 1, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        fd.flash_decode(q, k, k, pos)
