"""repro_torch — the PyTorch and CUDA port of :mod:`repro`.

The JAX package ``repro`` is the reference and stays as it is; this package
runs beside it and imports nothing of it (nor ``jax``). The KSA control
plane (``core``, ``pipeline``, ``autoscale``, ``obs``, ``cluster``) is a
verbatim copy with ``repro.`` renamed, held to its original by
``tests/test_torch_control_plane.py``. The numeric work is torch, and each
Pallas TPU kernel of the reference becomes a kernel written by hand for
Hopper under ``kernels/``. Entry points run on CUDA unless the caller asks
for the CPU.
"""
