"""Per-cell knobs and input specs of the train step. Port of the parts of
``repro/launch/specs.py`` that the sharded train step needs: the optimizer
and its analytic costs per arch, the train knobs (remat, microbatch,
accumulator dtype) and their clamp to a mesh, the abstract batch (``meta``
tensors in place of ``ShapeDtypeStruct``) and its shardings, and the
reduced-depth config.

``make_cell``, ``cache_sharding_tree``, ``decode_cache_shapes`` and the
dry-run come with the last sharded slice (``ROADMAP.md`` Queue 1, item 8).
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype
from repro_torch.optim import OptimizerConfig
from repro_torch.sharding.context import DistContext
from repro_torch.sharding.rules import axis_size


def optimizer_analytic_costs(cfg: ModelConfig, ocfg: OptimizerConfig,
                             accum_dtype: str, n_devices: int) -> dict:
    """Per-device FLOPs/bytes of the AdamW apply (pure elementwise over
    sharded state — no collectives). Counted analytically because the
    costing compiles cover only the fwd/bwd microbatch."""
    n = cfg.param_count(active_only=False)
    p_b = torch_dtype(cfg.dtype).itemsize
    m_b = torch_dtype(ocfg.moment_dtype).itemsize
    g_b = torch_dtype(accum_dtype).itemsize
    v_b = 0.01 * m_b if ocfg.factored_v else m_b
    mst_b = (0 if ocfg.master_dtype == "none"
             else torch_dtype(ocfg.master_dtype).itemsize)
    per_param_bytes = (g_b            # read grads
                       + 2 * p_b      # read + write params
                       + 2 * m_b      # read + write m
                       + 2 * v_b      # read + write v
                       + 2 * mst_b)   # read + write master
    return {
        "flops_per_device": 12.0 * n / n_devices,
        "bytes_per_device": per_param_bytes * n / n_devices,
        "collective_bytes": 0.0,
    }


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    """Memory policy per scale: the 671B config uses bf16 moments +
    factored second moment and no separate master copy — plain fp32 Adam
    does not fit 256×16 GB."""
    if cfg.name.startswith("deepseek"):
        return OptimizerConfig(moment_dtype="bfloat16", factored_v=True,
                               master_dtype="none")
    return OptimizerConfig()


def train_knobs(cfg: ModelConfig) -> dict:
    """remat / microbatch / accum dtype per arch for the train_4k cell.

    µ is sized so the per-microbatch fp32 logits working set stays within
    device memory: large-vocab/small-d archs (Gemma-3, InternVL) need
    µ=16."""
    if cfg.name.startswith("deepseek"):
        return {"remat": "full", "microbatch": 16, "accum_dtype": "bfloat16"}
    if cfg.name.startswith(("moonshot",)):
        return {"remat": "full", "microbatch": 8, "accum_dtype": "float32"}
    if cfg.padded_vocab >= 128_000 and cfg.d_model <= 4096:
        return {"remat": "full", "microbatch": 16, "accum_dtype": "float32"}
    return {"remat": "full", "microbatch": 4, "accum_dtype": "float32"}


def resolve_knobs(cfg: ModelConfig, dist: DistContext, global_batch: int,
                  overrides: dict | None = None) -> dict:
    """Clamp µ so each microbatch still shards over *all* batch axes —
    µ=16 on a 2×16×16 mesh would leave microbatches of 16 shardable over
    the pod axis only (16× per-device activation blowup)."""
    knobs = dict(train_knobs(cfg), **(overrides or {}))
    n_shards = axis_size(dist.mesh, dist.batch_axes)
    mu_max = max(1, global_batch // n_shards)
    mu = min(int(knobs.get("microbatch") or 1), mu_max)
    while mu > 1 and (global_batch // mu) % n_shards != 0:
        mu -= 1
    knobs["microbatch"] = mu
    return knobs


# ---------------------------------------------------------------------------
# batch construction
# ---------------------------------------------------------------------------

def _i32(shape):  # tokens / labels
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f32(shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def batch_specs(cfg: ModelConfig, b: int, s: int) -> dict:
    """Abstract training/prefill batch for one global step."""
    if cfg.frontend is not None and cfg.frontend.kind == "audio_frames":
        return {"embeds": _f32((b, s, cfg.frontend.input_dim)),
                "labels": _i32((b, s))}
    if cfg.frontend is not None and cfg.frontend.kind == "vit_patches":
        n_p = cfg.frontend.n_positions
        s_txt = max(s - n_p, 8)
        return {"embeds": _f32((b, n_p, cfg.frontend.input_dim)),
                "tokens": _i32((b, s_txt)),
                "labels": _i32((b, s_txt))}
    return {"tokens": _i32((b, s)), "labels": _i32((b, s))}


def batch_shardings(dist: DistContext, batch: dict, b: int) -> dict:
    """The PartitionSpec of every entry of ``batch``."""
    return {k: dist.batch_pspec(v.dim(), b) for k, v in batch.items()}


def reduced_depth(cfg: ModelConfig, n_periods: int) -> ModelConfig:
    """Same arch at ``n_periods`` periods (remainder layers preserved)."""
    return cfg.with_(n_layers=cfg.period * n_periods + cfg.n_remainder)
