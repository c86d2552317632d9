"""The CUDA flash-decode kernels against their plain PyTorch versions, on
the card: every case in float32 (the split's edges and groups of 10 and
16 query heads on a KV head included) and the serving main paths' shapes
in bf16 (recurrentgemma-2b's G = 10 among them), bit-identical over two
calls, one launch and no host synchronisation a call, every cluster size
from 1 to 16 splits, and the large shape, which the plan does not split.

Marked ``cuda``: they skip where no CUDA device is present. The file imports
no jax, so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_decode_cuda.py``.
"""
import numpy as np
import pytest
import torch

from _flash_decode_cases import (ATOL_BF16, ATOL_F32, CASES, LARGE_SHAPE,
                                 MAIN_PATH, main_path_cases, oracle)
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
    q = torch.zeros(2, 1, 17, 64, device=cuda_device)
    k = torch.zeros(2, 32, 1, 64, device=cuda_device)       # G = 17 > 16
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


def _inputs(case, device, dtype):
    t = {n: torch.from_numpy(case[n]).to(device, dtype)
         for n in ("q", "k", "v")}
    t["qpos"] = torch.from_numpy(case["qpos"]).to(device)
    idx = "table" if case["kind"] == "paged" else "kpos"
    t[idx] = torch.from_numpy(case[idx]).to(device)
    return t


def _call(case, t):
    if case["kind"] == "paged":
        return fd.flash_decode_paged(t["q"], t["k"], t["v"], t["qpos"],
                                     t["table"], window=case["window"])
    return fd.flash_decode(t["q"], t["k"], t["v"], t["qpos"], t["kpos"],
                           window=case["window"], bounded=case["bounded"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*MAIN_PATH, "long_sparse", "paged_gaps"])
def test_kernel_bit_identical_over_two_calls(name, cuda_device):
    """The splits merge in split order whatever order the blocks finish
    in, so two calls give the same bits."""
    if name in MAIN_PATH:
        case, dtype = main_path_cases()[name], torch.bfloat16
    else:
        case, dtype = CASES[name](), torch.float32
    t = _inputs(case, cuda_device, dtype)
    first = _call(case, t)
    second = _call(case, t)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [*MAIN_PATH, "no_valid_key"])
def test_kernel_call_does_not_synchronise(name, cuda_device):
    """The wrapper reads nothing back from the card: every call runs under
    the sync debug mode "error"."""
    if name in MAIN_PATH:
        case, dtype = main_path_cases()[name], torch.bfloat16
    else:
        case, dtype = CASES[name](), torch.float32
    t = _inputs(case, cuda_device, dtype)
    fd._library()                       # the build may not run under it
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = launches(case)
        _call(case, t)
        _call(case, t)
        assert launches(case) == before + 2
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("name", ["gemma3_1b_ring", "gemma3_1b_paged",
                                  "recurrentgemma_2b_ring", "group10_paged",
                                  "window_inside_splits", "paged_gaps"])
def test_every_cluster_size(name, n_split, cuda_device, monkeypatch):
    """The plan forced to n_split blocks a cluster (above 8 the non-portable
    size): the kernel still matches the plain version, and is bit-identical
    over two calls."""
    if name in MAIN_PATH:
        case, dtype, tol = main_path_cases()[name], torch.bfloat16, ATOL_BF16
    else:
        case, dtype, tol = CASES[name](), torch.float32, ATOL_F32
    monkeypatch.setattr(fd, "split_plan",
                        lambda n_units, unit_rows, pairs, n_sm:
                        fd.even_split(n_units, n_split))
    t = _inputs(case, cuda_device, dtype)
    got = _call(case, t)
    assert torch.equal(got, _call(case, t))
    f32 = {n: t[n].float() for n in ("q", "k", "v")}
    plain_case = dict(case, **{n: f32[n].cpu().numpy() for n in f32})
    want = run(plain_case, cuda_device, torch.float32, plain(case))
    torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MAIN_PATH)
def test_last_plan_is_the_launched_one(name, cuda_device):
    """The wrapper records the plan it gave the kernel: split_plan's choice
    for the call's shapes and this card's SM count, and the grid of
    (splits, KV heads x head groups, slots) blocks."""
    case = main_path_cases()[name]
    t = _inputs(case, cuda_device, torch.bfloat16)
    _call(case, t)
    b, h, kh = case["q"].shape[0], case["q"].shape[2], case["k"].shape[2]
    gh = fd.head_groups(h // kh)
    if case["kind"] == "paged":
        n_units, unit_rows = case["table"].shape[1], case["k"].shape[1]
    else:
        n_units, unit_rows = -(-case["k"].shape[1] // fd.TILE), fd.TILE
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n, per = fd.split_plan(n_units, unit_rows, b * kh * gh, sms)
    fn = fd.flash_decode_paged if case["kind"] == "paged" else fd.flash_decode
    assert fn.last_plan == (n, per, (n, kh * gh, b))


def _large(kind, device):
    """The large shape of chip_smoke.py's phase 9, every key valid."""
    c = LARGE_SHAPE
    gen = torch.Generator(device=device).manual_seed(11)
    b, s, kh, d = c["b"], c["s"], c["kh"], c["d"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.bfloat16)
    t = {"q": randn(b, 1, kh * c["g"], d),
         "qpos": torch.full((b,), s - 1, dtype=torch.int32, device=device)}
    if kind == "paged":
        ps = c["page_size"]
        perm = torch.randperm(b * (s // ps), generator=gen,
                              device=device) + 1
        t |= {"k": randn(b * (s // ps) + 1, ps, kh, d),
              "v": randn(b * (s // ps) + 1, ps, kh, d),
              "table": perm.reshape(b, s // ps).to(torch.int32)}
        return {"kind": "paged", "window": None}, t
    t |= {"k": randn(b, s, kh, d), "v": randn(b, s, kh, d),
          "kpos": torch.arange(s, dtype=torch.int32,
                               device=device).expand(b, s).contiguous()}
    return {"kind": "dense", "window": None, "bounded": True}, t


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_large_shape_is_not_split_and_reads_every_row(kind, cuda_device):
    """64 slots x 32 KV heads fill the card: one block a (slot, KV head)
    walks all 8192 rows, and the result is the plain version's."""
    c = LARGE_SHAPE
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    unit = c["page_size"] if kind == "paged" else fd.TILE
    assert fd.split_plan(c["s"] // unit, unit, c["b"] * c["kh"], sms) == (
        1, c["s"] // unit)
    case, t = _large(kind, cuda_device)
    got = _call(case, t)
    fn = fd.flash_decode_paged if kind == "paged" else fd.flash_decode
    assert fn.last_plan == (1, c["s"] // unit, (1, c["kh"], c["b"]))
    if kind == "paged":
        want = fd.flash_decode_paged_ref(t["q"], t["k"], t["v"], t["qpos"],
                                         t["table"])
    else:
        want = fd.flash_decode_ref(t["q"], t["k"], t["v"], t["qpos"],
                                   t["kpos"])
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL_BF16,
                               rtol=ATOL_BF16)
