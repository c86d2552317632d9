"""The program's configuration of a HuBERT-style encoder, built from the
sizes of the configuration file."""
from __future__ import annotations


def port_config(spec: dict, dtype: str):
    from repro_torch.models.config import FrontendConfig, ModelConfig
    heads = spec["num_attention_heads"]
    return ModelConfig(
        name=spec["name"], family="audio",
        n_layers=spec["num_hidden_layers"], d_model=spec["hidden_size"],
        vocab_size=spec["num_target_units"], n_heads=heads,
        n_kv_heads=heads, head_dim=spec["hidden_size"] // heads,
        d_ff=spec["intermediate_size"], layer_pattern=("attn",),
        mlp_kind="gelu", encoder_only=True,
        frontend=FrontendConfig(kind="audio_frames",
                                input_dim=spec["conv_dim"][-1]),
        rms_eps=spec["layer_norm_eps"], dtype=dtype)
