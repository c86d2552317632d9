"""Moving state between the JAX reference and the port.

A JAX param tree, after ``np.asarray`` on its leaves, is a nested dict or
list of numpy arrays; :func:`tree_to_torch` turns it into torch tensors
under the same keys, so a parity test can run the port on the reference's
weights. :func:`resolve_device` is the port's one rule for where work runs:
CUDA unless the caller asks for the CPU, and never quietly the CPU when
CUDA was asked for and is missing.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} asked for but CUDA is not "
                           f"available; pass device='cpu' to run on the CPU")
    return dev


def tree_to_torch(tree: Any, device: str | torch.device = "cuda") -> Any:
    """Nested dicts / lists / tuples of arrays -> the same nesting of
    tensors on ``device``. bfloat16 leaves (numpy's ``ml_dtypes`` type)
    keep their bits."""
    dev = resolve_device(device)

    def conv(x: Any) -> Any:
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        a = np.array(x)  # a writable copy: jax hands out read-only buffers
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)
