"""Runs of the harness on the CPU at toy sizes: the result line has exactly
the contract's keys; nothing under ``portbench/`` imports JAX or the JAX
package, and a set-up loads neither; the command refuses to run without a
card and prints no result."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tiny import TRAFFIC, tiny_run

HERE = Path(__file__).resolve().parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [
    ("mamba2-130m.train_4k", True), ("hubert-xlarge.train_crop", False),
    ("hubert-xlarge.encode_32k", True), ("hubert-xlarge.encode_short", False)])
def test_result_line_keys(workload, trace):
    run = tiny_run(workload, trace=trace)
    out = harness.run_cell(run)
    assert list(out) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in run.bench.metrics(workload, trace)}
    # the CPU has no device trace: the readers of device metrics find
    # nothing and the harness leaves them out
    assert set(out["metrics"]) <= names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for value, limit in out["checks"].values():
        assert 0 <= value <= limit
    json.dumps(out)


def test_window_positions():
    run = tiny_run("hubert-xlarge.encode_short", seconds=0.05)
    harness.run_cell(run)
    t = TRAFFIC["hubert-xlarge.encode_short"]
    assert run.positions == run.units * t["batch"] * t["seq"]
    assert run.window_s >= 0.05 and run.setup_s > 0


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        found = _imports(f) & set(harness.FORBIDDEN)
        assert not found, (f, found)
    for f in sorted((HERE / "reference").glob("*.py")):
        assert "repro_torch" not in _imports(f), f


def _python(code: str) -> subprocess.CompletedProcess:
    root = HERE.parent
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{root / 'src'}",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=240)


def test_a_set_up_loads_no_jax():
    proc = _python(
        "from portbench import harness\n"
        "from portbench.tiny import tiny_run\n"
        "harness.run_cell(tiny_run('mamba2-130m.train_4k', seconds=0.05))\n"
        "harness.run_cell(tiny_run('hubert-xlarge.encode_short', "
        "seconds=0.05))\n"
        "print(harness.forbidden_modules())\n")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_command_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "mamba2-130m.train_4k", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=HERE.parent, capture_output=True, text=True,
        timeout=240, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                              OMP_NUM_THREADS="1"))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
