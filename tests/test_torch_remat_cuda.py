"""Activation checkpointing on the card: one float32 train step under each
remat policy against the step without, on the gemma3 (flash attention)
and mamba2 (SSD scan) smoke configs, with the kernels' launch counts.

Marked ``cuda``: it skips where no CUDA device is present. The file imports
no jax: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_remat_cuda.py``.
"""
import pytest
import torch

from repro_torch import configs, data
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd
from repro_torch.optim import OptimizerConfig
from repro_torch.train import init_train_state, make_train_step
from repro_torch.tree import leaves

OPT = dict(lr=1e-3, eps=1e-5, warmup_steps=0, schedule="constant",
           weight_decay=0.1)
# arch: (kernel wrapper, the layer kinds that launch it)
KERNELS = {"gemma3_1b": (fa.flash_attention, ("attn", "local")),
           "mamba2_130m": (ssd.ssd_scan, ("ssd",))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _forward_launches(cfg, kinds, remat: str) -> int:
    in_periods = sum(k in kinds for k in cfg.layer_pattern) * cfg.n_periods
    tail = sum(k in kinds for k in cfg.layer_pattern[:cfg.n_remainder])
    return (1 if remat == "none" else 2) * in_periods + tail


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(KERNELS))
@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch"])
def test_remat_step_matches_no_remat_on_card(cuda_device, arch, policy):
    cfg = configs.smoke_config(arch)
    o = OptimizerConfig(**OPT)
    state = init_train_state(cfg, o, torch.Generator(device="cuda")
                             .manual_seed(0), "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             data.batch_at(cfg, 0, 0, batch=2, seq=128).items()}
    want, wm = make_train_step(cfg, o)(state, batch)
    wrapper, kinds = KERNELS[arch]
    before = wrapper.launches, wrapper.bwd_launches
    got, gm = make_train_step(cfg, o, remat=policy)(state, batch)
    torch.cuda.synchronize()
    assert wrapper.launches - before[0] == _forward_launches(cfg, kinds,
                                                             policy)
    assert wrapper.bwd_launches - before[1] == _forward_launches(
        cfg, kinds, "none")
    torch.testing.assert_close(gm["loss"], wm["loss"], atol=1e-5, rtol=1e-5)
    for a, b in zip(leaves(got.params), leaves(want.params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
