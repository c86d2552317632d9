"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]. Assigned: 24L d2048 32H
(kv=32) d_ff=5632 vocab=100352."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        n_layers=24, d_model=2048, vocab_size=100352,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632,
        layer_pattern=("attn",),
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke", family="dense",
        n_layers=2, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=160,
        layer_pattern=("attn",),
        dtype="float32", kv_chunk=64,
    )
