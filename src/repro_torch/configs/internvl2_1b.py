"""internvl2-1b [arXiv:2404.16821]. Assigned: 24L d896 14H (kv=2) d_ff=4864
vocab=151655. InternViT frontend is a STUB: inputs are precomputed 1024-dim
patch embeddings (256 patches) projected and prepended to the text."""
from repro_torch.models.config import FrontendConfig, ModelConfig

N_PATCHES = 256


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, vocab_size=151655,
        n_heads=14, n_kv_heads=2, head_dim=64, d_ff=4864,
        layer_pattern=("attn",),
        frontend=FrontendConfig(kind="vit_patches", input_dim=1024,
                                n_positions=N_PATCHES),
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", family="vlm",
        n_layers=2, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
        layer_pattern=("attn",),
        frontend=FrontendConfig(kind="vit_patches", input_dim=32,
                                n_positions=8),
        dtype="float32", kv_chunk=64,
    )
