"""moonshot-v1-16b-a3b — Moonlight-style MoE, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B]. Assigned: 48L d2048 16H (kv=16) d_ff=1408
(expert dim) vocab=163840."""
from repro_torch.models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        n_layers=48, d_model=2048, vocab_size=163840,
        n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=0,  # all FFN capacity is in the experts
        layer_pattern=("attn",),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      capacity_factor=1.25),
        rope_theta=50_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", family="moe",
        n_layers=2, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0,
        layer_pattern=("attn",),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                      capacity_factor=8.0),
        dtype="float32", kv_chunk=64,
    )
