"""The port's examples (``examples/torch_*.py``) run to completion on the
CPU at their smallest size, each in a fresh interpreter where ``jax`` and
the JAX package ``repro`` cannot be imported, and import ``repro_torch``
only through its package roots (``repro_torch.<package>``, never a module
inside a subpackage), as ``tests/test_api_surface.py`` holds the
reference's examples to.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))

# smallest sizes; --device cpu, as the examples default to cuda
RUNS = {
    "quickstart": ("torch_quickstart.py", []),
    "serve_batch": ("torch_serve_batch.py", []),
    "train_ft": ("torch_train_ft.py", ["--steps", "4", "--chunk", "2"]),
    "knot_campaign": ("torch_knot_campaign.py",
                      ["--structures", "24", "--batch-size", "8",
                       "--n-points", "48"]),
    "knot_campaign_autoscale": ("torch_knot_campaign.py",
                                ["--structures", "24", "--batch-size", "8",
                                 "--n-points", "48", "--autoscale"]),
    "knot_campaign_sites2": ("torch_knot_campaign.py",
                             ["--structures", "24", "--batch-size", "8",
                              "--n-points", "48", "--sites", "2"]),
}

_RUNNER = r"""
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
"""


def test_every_port_example_is_run():
    assert {p.name for p in EXAMPLES} == {f for f, _ in RUNS.values()}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name):
    script, argv = RUNS[name]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER, str(ROOT / "examples" / script),
         *argv, "--device", "cpu"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK", out.stdout[-3000:]


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_example_imports_package_roots_only(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        elif isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        else:
            continue
        for mod in names:
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path.name, mod)
            if root == "repro_torch":
                assert mod.count(".") <= 1, (path.name, mod)
