"""recurrentgemma-2b [arXiv:2402.19427]. Assigned: 26L d2560 10H (kv=1)
d_ff=7680 vocab=256000, RG-LRU + local attention at 1:2 (pattern
(rglru, rglru, local), window 2048), lru_width 2560, head_dim 256."""
from repro_torch.models.config import ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, vocab_size=256000,
        n_heads=10, n_kv_heads=1, head_dim=256, d_ff=7680,
        layer_pattern=("rglru", "rglru", "local"),
        window_size=2048, mlp_kind="geglu",
        rglru=RGLRUConfig(lru_width=2560, conv_width=4),
        tie_embeddings=True, scale_embeddings=True,
        rope_theta=10_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=5, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=160,
        layer_pattern=("rglru", "rglru", "local"),
        window_size=32, mlp_kind="geglu",
        rglru=RGLRUConfig(lru_width=64, conv_width=4),
        tie_embeddings=True, scale_embeddings=True,
        dtype="float32", kv_chunk=64,
    )
