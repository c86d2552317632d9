"""The program's configuration of a Mamba-2 language model, built from the
sizes of the configuration file."""
from __future__ import annotations


def port_config(spec: dict, dtype: str):
    from repro_torch.models.config import ModelConfig, SSMConfig
    return ModelConfig(
        name=spec["name"], family="ssm", n_layers=spec["n_layer"],
        d_model=spec["d_model"], vocab_size=spec["vocab_size"], d_ff=0,
        layer_pattern=("ssd",),
        ssm=SSMConfig(d_state=spec["d_state"], d_conv=spec["d_conv"],
                      expand=spec["expand"], head_dim=spec["headdim"],
                      chunk_size=spec["chunk_size"]),
        tie_embeddings=spec["tie_embeddings"], rms_eps=spec["norm_epsilon"],
        dtype=dtype)
