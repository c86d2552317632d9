"""The one traffic generator: a mix's parameters (``traffic/<mix>.json``)
and the configuration's inputs become tensors on the device, drawn from the
run's seed in one call per tensor.

A mix gives ``batch`` rows of ``seq`` positions and ``pool`` distinct
batches, which the window cycles through. What a row holds comes from the
reference module of the configuration (``inputs(spec)``): token ids for a
language model (a row of ``seq + 1`` ids, shifted by one for the labels),
or frames of a fixed width with target units for an encoder of frames.
"""
from __future__ import annotations

import torch

from portbench.reference.common import sub_seed


def make_batches(traffic: dict, inputs: dict, seed: int, device,
                 dtype: torch.dtype) -> list[dict]:
    """``traffic["pool"]`` batches, each a dict of (batch, seq, ...)
    tensors on ``device``; frames in ``dtype``."""
    n, b, s = traffic["pool"], traffic["batch"], traffic["seq"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "data"))
    if inputs["kind"] == "tokens":
        ids = torch.randint(0, inputs["vocab"], (n, b, s + 1),
                            generator=gen, device=device, dtype=torch.int32)
        return [{"tokens": ids[i, :, :-1].contiguous(),
                 "labels": ids[i, :, 1:].contiguous()} for i in range(n)]
    if inputs["kind"] == "frames":
        frames = torch.randn((n, b, s, inputs["width"]), generator=gen,
                             device=device, dtype=dtype)
        labels = torch.randint(0, inputs["units"], (n, b, s), generator=gen,
                               device=device, dtype=torch.int32)
        return [{"embeds": frames[i], "labels": labels[i]} for i in range(n)]
    raise ValueError(f"unknown input kind {inputs['kind']!r}")
