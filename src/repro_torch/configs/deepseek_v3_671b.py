"""deepseek-v3-671b — MLA + 256-expert MoE (1 shared, top-8)
[arXiv:2412.19437]. Assigned: 61L d_model=7168 128H d_ff=2048 (expert dim)
vocab=129280. MLA dims per the paper: q_lora 1536, kv_lora 512, rope 64,
nope 128, v 128. (MTP head is an optional extension, see DESIGN.md.)"""
from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, vocab_size=129280,
        n_heads=128, n_kv_heads=128, head_dim=128,
        d_ff=0,
        layer_pattern=("attn",),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      capacity_factor=1.25),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe",
        n_layers=2, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=0,
        layer_pattern=("attn",),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                      capacity_factor=8.0),
        dtype="float32", kv_chunk=64,
    )
