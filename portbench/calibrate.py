"""The readings that the correctness limits are set from, at a cell's own
sizes, on the card: for each seed the program's numbers against the
reference, and on the first ``--control-seeds`` seeds the control's and
each planted fault's.

    python portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 3] [--out <file.json>]

* program: the harness's own set-up (a training cell's checked steps; an
  encoding cell's ``check_calls`` calls at its load), then the reference;
* control: the reference computed with fp8 (e4m3) products, the step below
  the configuration's bf16, put in the program's place;
* faults of a training cell: half of the batch left out and the mean taken
  over the rest, and a step that returns its state unchanged (learning
  rate 0), each planted in the reference put in the program's place; of an
  encoding cell: one position's logits replaced by
  the next position's, where the program produced them.

The benchmark's runs never run this. Prints one JSON line a seed and
writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _train(run, control: bool) -> dict:
    import torch

    from portbench.check import train_detail, train_gaps
    from portbench.drivers import train
    from portbench.reference.common import FP8
    data = train.batches(run)
    n = run.traffic["check_steps"]
    step, state, prog = train.program_setup(run, data)
    del step, state
    torch.cuda.empty_cache()
    ref = train.reference(run, data[:n])
    out = {"program": train_gaps(prog, ref),
           "program_detail": train_detail(prog, ref)}
    if control:
        recipe = run.spec["train"]
        frozen = replace(run, spec=dict(run.spec, train=dict(
            recipe, optimizer=dict(recipe["optimizer"], lr=0.0))))
        faults = {"control": train.reference(run, data[:n], FP8),
                  "half_batch": train.reference(
                      run, data[:n], rows=run.traffic["batch"] // 2),
                  "unchanged": train.reference(frozen, data[:n])}
        for name, got in faults.items():
            out[name] = train_gaps(got, ref)
            out[name + "_detail"] = train_detail(got, ref)
    return out


def _encode(run, control: bool) -> dict:
    import torch

    from portbench.check import encode_gaps, worst_of
    from portbench.drivers import encode
    from portbench.reference.common import FP8
    data = encode.batches(run)
    call, params = encode.program(run)
    frames = data[:run.traffic["check_calls"]]
    got = [call(params, {"embeds": f}) for f in frames]
    torch.cuda.synchronize()
    del call, params
    torch.cuda.empty_cache()
    want = encode.reference(run, frames)

    def gaps(outs):
        return worst_of([encode_gaps(encode.unit_logits(run, g),
                                     encode.unit_logits(run, w))
                         for g, w in zip(outs, want)])

    out = {"program": gaps(got)}
    if control:
        out["control"] = gaps(encode.reference(run, frames, FP8))
        altered = [g.clone() for g in got]
        altered[0][0, 0] = altered[0][0, 1]
        out["altered_answer"] = gaps(altered)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.Bench()
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.make_run(bench, args.workload, seed, 0.0, False,
                               "cuda", t0)
        fn = _train if run.kind == "train" else _encode
        row = {"workload": args.workload, "seed": seed,
               **fn(run, i < args.control_seeds),
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
