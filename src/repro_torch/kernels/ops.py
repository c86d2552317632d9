"""Dispatch wrappers: the hand-written kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor. Counterpart of ``repro/kernels/ops.py``,
without its interpret-mode switch: the device of the tensor decides."""
from __future__ import annotations

import torch

from .writhe import writhe_map


def writhe(coords: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """(B, n, 3) -> (B, n-1, n-1) writhe map. ``use_pallas`` is accepted for
    signature parity with the reference and ignored: a CUDA tensor always
    runs the CUDA kernel, a CPU tensor the plain version."""
    del use_pallas
    return writhe_map(coords)
