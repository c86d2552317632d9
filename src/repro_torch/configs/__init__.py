"""Architecture registry: the 10 assigned configs + shapes + cell rules.

Every entry provides:

* ``config()``        — the exact assigned full-size :class:`ModelConfig`,
* ``smoke_config()``  — a reduced same-family config for CPU smoke tests,
* shape cells via :func:`cells_for` with the assignment's skip rules.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

ARCHS = (
    "moonshot_v1_16b_a3b",
    "deepseek_v3_671b",
    "stablelm_1_6b",
    "gemma3_1b",
    "internlm2_1_8b",
    "gemma3_4b",
    "hubert_xlarge",
    "recurrentgemma_2b",
    "internvl2_1b",
    "mamba2_130m",
)

# canonical ids as given in the assignment (dashes)
CANONICAL = {a: a.replace("_", "-").replace("-1-6b", "-1.6b")
             .replace("-1-8b", "-1.8b") for a in ARCHS}


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# long_500k runs only for sub-quadratic stacks (SSM / hybrid / mostly-local);
# decode shapes are skipped for encoder-only archs. See DESIGN.md §4.
_SUBQUADRATIC = {"mamba2_130m", "recurrentgemma_2b", "gemma3_1b", "gemma3_4b"}


def _norm(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return key


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.config()


def smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_norm(name)}")
    return mod.smoke_config()


def cells_for(name: str) -> list[Shape]:
    key = _norm(name)
    cfg = get_config(key)
    out = []
    for shape in SHAPES.values():
        if shape.step == "decode" and cfg.encoder_only:
            continue  # no decode step for encoders
        if shape.name == "long_500k" and key not in _SUBQUADRATIC:
            continue  # needs sub-quadratic attention
        out.append(shape)
    return out


def all_cells() -> list[tuple[str, Shape]]:
    return [(a, s) for a in ARCHS for s in cells_for(a)]
