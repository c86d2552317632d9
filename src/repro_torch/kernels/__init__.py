"""Hand-written Hopper kernels, each beside its plain PyTorch version. Each
wrapper launches its kernel for a CUDA tensor and runs the plain version
for a CPU tensor:

* ``writhe.writhe_map`` — the paper's workload: the Gauss-linking writhe
  map (``csrc/writhe.cu``, CUDA C++ for ``sm_90a``), also reached through
  ``ops.writhe``;
* ``flash_decode.flash_decode`` and ``flash_decode.flash_decode_paged`` —
  single-token decode attention over a dense and a paged KV cache
  (``csrc/flash_decode.cu``, CUDA C++ for ``sm_90a``), reached by the model
  through ``decode_attention`` and ``decode_attention_paged``;
* ``ssd.ssd_scan`` — the Mamba-2 chunked SSD scan with initial and final
  state (``csrc/ssd.cu``, CUDA C++ for ``sm_90a``; its gradient through the
  plain version), reached by the model through ``models.ssd.ssd_chunked``.

``build.py`` compiles the ``csrc/*.cu`` sources with ``nvcc`` at first use.
"""
from . import ops

__all__ = ["ops"]
