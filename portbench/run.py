"""Run one cell of the benchmark once, on the card, and print its result.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit. The same numbers end
standard error. Without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it exits
with a code other than 0 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def _environment() -> None:
    """Fixed caches inside the checkout, one allocator setting, and no
    JAX behind any library the program loads. Set before torch loads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from portbench import harness
    bench = harness.Bench()
    chips = bench.workload(args.workload)["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = harness.make_run(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    run.phase("imports_and_context")
    result = harness.run_cell(run)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{loaded}", file=sys.stderr)
        return 3
    print(f"setup phases (s from start) {json.dumps(run.phases)}",
          file=sys.stderr)
    for name, value in run.gaps.items():
        if name not in result["checks"]:
            print(f"reading {name} {value!r} (no limit: not compared)",
                  file=sys.stderr)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
