"""gemma3-4b [hf:google/gemma-3-4b family]. Assigned: 34L d2560 8H (kv=4)
d_ff=10240 vocab=262144, 5:1 local:global (window 1024)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, vocab_size=262144,
        n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240,
        layer_pattern=("local",) * 5 + ("attn",),
        window_size=1024, mlp_kind="geglu",
        use_qk_norm=True, tie_embeddings=True, scale_embeddings=True,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=8, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
        layer_pattern=("local",) * 2 + ("attn",),
        window_size=32, mlp_kind="geglu",
        use_qk_norm=True, tie_embeddings=True, scale_embeddings=True,
        dtype="float32", kv_chunk=64,
    )
