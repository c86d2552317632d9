"""The CUDA writhe kernel against its plain PyTorch version, on the card.

Marked ``cuda``: it skips where no CUDA device is present. It imports no jax,
so it runs on a GPU machine without the JAX reference:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_writhe_cuda.py``.
"""
import numpy as np
import pytest
import torch

from _writhe_cases import CASES, WR_REL, check, walk
from repro_torch.apps import knots
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


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_sums_match_plain_on_card(case, cuda_device):
    """The fused entry point: its map is the map kernel's and the plain
    version's (at ``check``); its sums within WR_REL of the plain version's
    in float64, scaled by the ACN (the sum of the magnitudes whose
    round-off a writhe collects, which may itself cancel to ~0); against
    its own map summed in float64, each sum within 1e-5 of the ACN and the
    mean ACN within 1e-5; both outputs the same bits on a second call; one
    launch a call."""
    coords = torch.from_numpy(CASES[case]().astype(np.float32)).to(cuda_device)
    launched = int(coords.shape[0] > 0 and coords.shape[1] >= 3)
    before = writhe.writhe_map.launches
    wr, acn, w = writhe.writhe_map_sums(coords)
    torch.cuda.synchronize()
    assert writhe.writhe_map.launches == before + launched
    again = writhe.writhe_map_sums(coords)
    for first, second in zip((wr, acn, w), again):
        assert torch.equal(first, second)
    assert torch.equal(w, writhe.writhe_map(coords))
    _, _, want_w = writhe.writhe_sums_ref(coords)
    check(w.cpu().numpy(), want_w.cpu().numpy(), case)
    ewr, eacn, _ = writhe.writhe_sums_ref(coords.double())
    scale = WR_REL * eacn
    assert bool(((wr.double() - ewr).abs() <= scale).all()), (wr, ewr)
    assert bool(((acn.double() - eacn).abs() <= scale).all()), (acn, eacn)
    own = w.double()
    own_wr, own_acn = own.sum(dim=(1, 2)) / 2, own.abs().sum(dim=(1, 2)) / 2
    assert bool(((wr.double() - own_wr).abs() <= 1e-5 * own_acn).all())
    assert bool(((acn.double() - own_acn).abs() <= 1e-5 * own_acn).all())
    if coords.shape[0]:
        mean, own_mean = float(acn.double().mean()), float(own_acn.mean())
        assert abs(mean - own_mean) <= 1e-5 * abs(own_mean), (mean, own_mean)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [31, 32, 33, 63, 511, 512])
def test_map_exactly_symmetric_at_tile_edges(segments, cuda_device):
    """n - 1 one below, at and one above a multiple of the 32-wide tile: both
    entry points write every entry (the mirror of a ragged edge tile
    included), exactly symmetric, and the same map."""
    coords = torch.from_numpy(np.concatenate(
        [walk(segments + 1, s) for s in range(3)]).astype(np.float32))
    x = coords.to(cuda_device)
    w = writhe.writhe_map(x)
    wr, acn, w2 = writhe.writhe_map_sums(x)
    torch.cuda.synchronize()
    assert w.shape == (3, segments, segments)
    assert bool(torch.isfinite(w).all())
    assert torch.equal(w, w.transpose(1, 2))
    assert torch.equal(w, w2)
    check(w.cpu().numpy(), writhe.writhe_map_ref(x).cpu().numpy(),
          f"walk n-1={segments}")
    ewr, eacn, _ = writhe.writhe_sums_ref(x.double())
    assert bool(((wr.double() - ewr).abs() <= WR_REL * eacn).all())
    assert bool(((acn.double() - eacn).abs() <= WR_REL * eacn).all())


@pytest.mark.cuda
def test_writhe_and_acn_is_one_launch_on_card(cuda_device):
    """The screen's sums on the card: one kernel launch (counted, and the
    only kernel the profiler sees; the tickets' memset is no kernel), the
    fused entry point's outputs, and no second map-sized tensor (peak
    memory: the map, its partials, the tickets and the sums)."""
    coords, _ = knots.synthesize_batch(list(range(16)), 256)
    x = torch.from_numpy(coords).to(cuda_device)
    knots.writhe_and_acn(x)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = writhe.writhe_map.launches
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        wr, acn, w = knots.writhe_and_acn(x)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert writhe.writhe_map.launches == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memset" not in e.name.lower()]
    assert len(kernels) == 1 and "writhe_kernel" in kernels[0], kernels
    assert peak < 1.5 * w.numel() * 4, (peak, w.numel() * 4)
    for got, want in zip((wr, acn, w), writhe.writhe_map_sums(x)):
        assert torch.equal(got, want)
