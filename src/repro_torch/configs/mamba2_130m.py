"""mamba2-130m [arXiv:2405.21060]. Assigned: 24L d768 (attn-free) d_ff=0
vocab=50280, ssm_state=128, SSD. expand=2 -> d_inner 1536, head_dim 64 ->
24 SSD heads."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, vocab_size=50280,
        d_ff=0,
        layer_pattern=("ssd",),
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=3, d_model=64, vocab_size=512,
        d_ff=0,
        layer_pattern=("ssd",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=32),
        tie_embeddings=True,
        dtype="float32", kv_chunk=64,
    )
