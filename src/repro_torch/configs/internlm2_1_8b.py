"""internlm2-1.8b [arXiv:2403.17297]. Assigned: 24L d2048 16H (kv=8)
d_ff=8192 vocab=92544, GQA."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, vocab_size=92544,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192,
        layer_pattern=("attn",),
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke", family="dense",
        n_layers=2, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
        layer_pattern=("attn",),
        dtype="float32", kv_chunk=64,
    )
