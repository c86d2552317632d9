"""gemma3-1b [hf:google/gemma-3-1b-pt]. Assigned: 26L d1152 4H (kv=1)
d_ff=6912 vocab=262144, 5:1 local:global (window 512), 128k context.
Gemma-3 particulars: head_dim 256, qk-norm, tied + scaled embeddings, geglu,
RoPE theta 10k local / 1M global."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, vocab_size=262144,
        n_heads=4, n_kv_heads=1, head_dim=256, d_ff=6912,
        layer_pattern=("local",) * 5 + ("attn",),
        window_size=512, mlp_kind="geglu",
        use_qk_norm=True, tie_embeddings=True, scale_embeddings=True,
        rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b-smoke", family="dense",
        n_layers=8, d_model=64, vocab_size=512,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=160,
        layer_pattern=("local",) * 2 + ("attn",),
        window_size=32, mlp_kind="geglu",
        use_qk_norm=True, tie_embeddings=True, scale_embeddings=True,
        dtype="float32", kv_chunk=64,
    )
