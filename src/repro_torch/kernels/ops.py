"""Dispatch wrappers: the hand-written kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor. Counterpart of ``repro/kernels/ops.py``,
without its interpret-mode switch: the device of the tensor decides."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .writhe import writhe_map


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              use_pallas: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D) -> (B, Sq, H, D) attention.
    ``use_pallas`` is accepted for signature parity with the reference and
    ignored: a CUDA tensor always runs the CUDA kernel, a CPU tensor the
    plain version. Keys are taken in one chunk, as the reference's
    ``attention_ref`` takes them."""
    del use_pallas
    return flash_attention(q, k, v, causal=causal, window=window,
                           kv_chunk=max(int(k.shape[1]), 1))


def writhe(coords: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """(B, n, 3) -> (B, n-1, n-1) writhe map. ``use_pallas`` is accepted for
    signature parity with the reference and ignored: a CUDA tensor always
    runs the CUDA kernel, a CPU tensor the plain version."""
    del use_pallas
    return writhe_map(coords)
