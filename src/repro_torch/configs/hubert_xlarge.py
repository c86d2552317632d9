"""hubert-xlarge [arXiv:2106.07447]. Assigned: 48L d1280 16H (kv=16)
d_ff=5120 vocab=504 (k-means target units), encoder-only. The conv waveform
frontend is a STUB: inputs are precomputed 512-dim frame embeddings."""
from repro_torch.models.config import FrontendConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, vocab_size=504,
        n_heads=16, n_kv_heads=16, head_dim=80, d_ff=5120,
        layer_pattern=("attn",), mlp_kind="gelu",
        encoder_only=True,
        frontend=FrontendConfig(kind="audio_frames", input_dim=512),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio",
        n_layers=2, d_model=64, vocab_size=64,
        n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        layer_pattern=("attn",), mlp_kind="gelu",
        encoder_only=True,
        frontend=FrontendConfig(kind="audio_frames", input_dim=32),
        dtype="float32", kv_chunk=64,
    )
