"""The model core of the port: configs, parameter specs, layers, attention
and the transformer stack, for every config in ``repro_torch.configs``:
the ``attn``/``local`` layer kinds (GQA or MLA), the Mamba-2 ``ssd`` and
RG-LRU ``rglru`` kinds, dense-MLP and MoE FFNs, and the stub
``audio_frames`` and ``vit_patches`` frontends. It exports what the
reference's ``models`` package exports; the blocks live in their modules
(``attention``, ``mla``, ``moe``, ``rglru``, ``ssd``).

``config.py`` is a verbatim copy of the reference's. Its ``use_pallas`` and
``kernel_interpret`` fields stay, since a copy stays as it is, but the port
reads neither: a CUDA tensor always runs the hand-written kernels and a CPU
tensor their plain versions.
"""
from .config import (FrontendConfig, MLAConfig, ModelConfig, MoEConfig,
                     RGLRUConfig, SSMConfig)
from .params import (count_params, init_params, logical_axes, param_shapes,
                     ParamSpec)
from .transformer import (block_apply, block_spec, cache_shapes, forward,
                          init_caches, model_spec)

__all__ = [
    "FrontendConfig", "MLAConfig", "ModelConfig", "MoEConfig", "ParamSpec",
    "RGLRUConfig", "SSMConfig", "block_apply", "block_spec", "cache_shapes",
    "count_params", "forward", "init_caches", "init_params", "logical_axes",
    "model_spec", "param_shapes",
]
