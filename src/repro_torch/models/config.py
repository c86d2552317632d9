"""Model configuration schema for the architecture zoo.

One :class:`ModelConfig` describes every assigned architecture; the layer
stack is generated from ``layer_pattern`` (cycled across ``n_layers``), which
covers homogeneous transformers (pattern ``("attn",)``), Gemma-3's 5:1
local:global attention, RecurrentGemma's (rglru, rglru, local) hybrid, and
Mamba-2's attention-free ``("ssd",)`` stack.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Literal, Sequence

LayerKind = Literal["attn", "local", "ssd", "rglru"]
MlpKind = Literal["swiglu", "geglu", "gelu"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # expert FFN hidden dim
    n_shared: int = 0              # always-on shared experts (DeepSeek-V3)
    capacity_factor: float = 1.25  # dispatch capacity (dropped-token bound)
    router_aux_weight: float = 1e-3
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims (arXiv:2412.19437)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (arXiv:2405.21060)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    # n_heads = d_model * expand // head_dim, derived.


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block (arXiv:2402.19427)."""
    lru_width: int | None = None   # default: d_model
    conv_width: int = 4
    c: float = 8.0                 # the fixed constant in a = exp(-c*softplus(L)*sigmoid(rx))


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: inputs are *precomputed* frame/patch
    embeddings; the frontend is a learned projection into d_model."""
    kind: Literal["audio_frames", "vit_patches"]
    input_dim: int               # embedding dim delivered by the stub
    n_positions: int = 0         # patches prepended before text (vlm only)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    layer_pattern: tuple[str, ...] = ("attn",)
    window_size: int = 1024                 # for "local" layers
    mlp_kind: MlpKind = "swiglu"
    encoder_only: bool = False              # bidirectional, no decode step
    use_qk_norm: bool = False
    tie_embeddings: bool = False
    scale_embeddings: bool = False          # gemma-style sqrt(d_model)
    rope_theta: float = 10_000.0
    rope_theta_global: float | None = None  # gemma3 global layers use 1e6
    rms_eps: float = 1e-6
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    frontend: FrontendConfig | None = None
    # numerics
    dtype: str = "bfloat16"                 # activations/weights compute dtype
    # attention implementation knobs
    kv_chunk: int = 1024                    # chunked-softmax KV block
    use_pallas: bool = False                # TPU kernels (tests use interpret)
    decode_kernel: str = "chunked"          # serving decode: "chunked"
                                            # (reference) | "flash"
                                            # (split-KV flash-decode)
    kernel_interpret: bool = False          # Pallas interpret mode (CPU
                                            # parity tests)
    logit_dtype: str = "float32"
    score_dtype: str = "float32"            # attention score/probability dtype
                                            # (bf16 halves the S×chunk buffers)

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style) so the unembed
        can always be vocab-parallel on the model axis; labels never hit the
        padding and serve_step masks it out of sampling."""
        return -(-self.vocab_size // 256) * 256

    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def n_remainder(self) -> int:
        return self.n_layers % self.period

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssd_heads(self) -> int:
        assert self.ssm is not None
        return (self.d_model * self.ssm.expand) // self.ssm.head_dim

    @property
    def ssd_inner(self) -> int:
        assert self.ssm is not None
        return self.d_model * self.ssm.expand

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter count (for 6·N·D roofline bookkeeping) -------------------

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count; ``active_only`` counts top-k+shared
        experts only (the N in MoE 6·N_active·D)."""
        d, v = self.d_model, self.padded_vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += d * v
        kinds = self.layer_kinds()
        for kind in kinds:
            n += 2 * d  # two RMSNorm scales per block
            if kind in ("attn", "local"):
                if self.mla is not None:
                    m = self.mla
                    n += d * m.q_lora_rank + m.q_lora_rank  # q down + norm
                    n += m.q_lora_rank * self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                    n += d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank
                    n += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    n += self.n_heads * m.v_head_dim * d
                else:
                    n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            elif kind == "ssd":
                s = self.ssm
                di = self.ssd_inner
                h = self.ssd_heads
                n += d * (2 * di + 2 * s.d_state + h)      # in_proj(z,x,B,C,dt)
                n += s.d_conv * (di + 2 * s.d_state)       # conv over x,B,C
                n += di + 2 * s.d_state                    # conv bias
                n += 3 * h                                 # A_log, dt_bias, D
                n += di                                    # gate norm scale
                n += di * d                                # out_proj
            elif kind == "rglru":
                r = self.rglru or RGLRUConfig()
                w = r.lru_width or d
                n += d * 2 * w + r.conv_width * w  # x/gate in-projs + conv
                n += 2 * w * w                     # input & recurrence gates
                n += w                             # Lambda
                n += w * d                         # out proj
            # MLP
            if kind in ("attn", "local"):
                if self.moe is not None:
                    e = self.moe
                    n_router = d * e.n_experts
                    per_expert = 3 * d * e.d_expert
                    n += n_router
                    if active_only:
                        n += (e.top_k + e.n_shared) * per_expert
                    else:
                        n += (e.n_experts + e.n_shared) * per_expert
                else:
                    mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    n += mult * d * self.d_ff
            elif kind in ("ssd", "rglru"):
                # ssd/rglru blocks in these configs are followed by their own
                # MLP block only in hybrid stacks; mamba2 is MLP-free.
                if self.d_ff:
                    mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    n += mult * d * self.d_ff + 2 * d
        if self.frontend is not None:
            n += self.frontend.input_dim * d + d
        n += d  # final norm
        return n
