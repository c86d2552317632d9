"""An encoding cell: the program's ``make_prefill_step`` of an encoder,
called back to back on the mix's batches of frames.

Set-up draws the weights and the batches and warms the call up once (the
window's one shape). The window keeps a sample of its calls' logits, drawn
from the seed (:class:`portbench.harness.Reservoir`); once the window (and a
traced stretch) is over and the program's weights are freed, the reference
encodes the same batches and the check compares every kept call.
"""
from __future__ import annotations

import time

import torch

from portbench import harness
from portbench.check import encode_gaps, worst_of
from portbench.generate import make_batches
from portbench.reference.common import FULL, Precision, no_tf32, tree_map


def batches(run: harness.Run) -> list[torch.Tensor]:
    return [b["embeds"] for b in make_batches(
        run.traffic, run.ref.inputs(run.spec), run.seed, run.device,
        run.dtype)]


def program(run: harness.Run):
    """(the program's encoding call, its weights)."""
    from repro_torch.train.step import make_prefill_step
    cfg = run.adapter.port_config(run.spec, run.spec["dtype"])
    params = run.weights()
    harness.check_layout(cfg, params)
    return make_prefill_step(cfg), params


def reference(run: harness.Run, frames: list[torch.Tensor],
              prec: Precision = FULL) -> list[torch.Tensor]:
    """The reference's logits of each batch of ``frames``: float32 (or
    ``prec``'s) products on the configuration's weights."""
    no_tf32()
    w = tree_map(lambda t: t.float(), run.weights())
    with torch.no_grad():
        return [run.ref.logits(w, run.spec, f.float(), prec) for f in frames]


def unit_logits(run: harness.Run, logits: torch.Tensor) -> torch.Tensor:
    """The real units' columns of padded logits."""
    return logits[..., :run.ref.inputs(run.spec)["units"]]


def drive(run: harness.Run) -> None:
    data = batches(run)
    run.phase("batches")
    call, params = program(run)
    run.phase("weights")
    call(params, {"embeds": data[0]})
    harness.synchronize(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    sample = harness.Reservoir(run.traffic["check_calls"], run.seed)
    box = {"i": 0}

    def launch():
        j = box["i"] % len(data)
        sample.offer((j, call(params, {"embeds": data[j]})))
        box["i"] += 1

    harness.window(run, launch)
    kept = sample.kept
    if run.trace:
        box["i"] = 0
        sample = harness.Reservoir(0, run.seed)
        harness.traced(run, run.traffic["trace_calls"], launch)
    if run.device.startswith("cuda"):
        run.memory_peak = torch.cuda.max_memory_allocated()
    del params, call
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()
    want = reference(run, [data[j] for j, _ in kept])
    run.gaps = worst_of([encode_gaps(unit_logits(run, got),
                                     unit_logits(run, ref))
                         for (_, got), ref in zip(kept, want)])
