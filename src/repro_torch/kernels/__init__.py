"""Hand-written Hopper kernels, each beside its plain PyTorch version, with a
dispatch wrapper (``ops.py``) that launches the kernel for a CUDA tensor and
runs the plain version for a CPU tensor:

* ``writhe`` — the paper's workload: the Gauss-linking writhe map
  (``csrc/writhe.cu``, CUDA C++ for ``sm_90a``).

``build.py`` compiles the ``csrc/*.cu`` sources with ``nvcc`` at first use.
"""
from . import ops

__all__ = ["ops"]
