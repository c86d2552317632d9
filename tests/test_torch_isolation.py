"""The port imports neither ``jax`` nor anything of the JAX package ``repro``.

Checked twice: in the source text of every module under ``src/repro_torch``,
of ``chip_smoke.py`` and of the port's examples (``examples/torch_*.py``;
every ``import`` statement, at any depth), and by
importing every module in a fresh interpreter where those names cannot be
found. ``msgpack`` is blocked there too: the port's in-memory broker runs
without it.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))
BANNED = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax_or_repro(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


_PROBE = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)

from repro_torch.core import Broker
b = Broker(default_partitions=1)
b.produce("t", {"x": 1}, key="k")
assert [r.value for r in b.read_from("t", 0)] == [{"x": 1}]
b.close()
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print(len(names))
"""


def test_every_module_imports_without_jax_repro_or_msgpack():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 35


def test_training_slice_is_covered():
    """The training slice's subpackages and the flash-attention kernel's
    module are among the files checked above and import in the blocked
    interpreter (walk_packages finds them)."""
    rel = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    for need in ("optim/adamw.py", "optim/schedule.py", "data/synthetic.py",
                 "checkpoint/saver.py", "train/trainer.py", "train/loss.py",
                 "models/ssd.py", "kernels/ssd.py", "tree.py",
                 "kernels/flash_attention.py", "models/attention.py"):
        assert need in rel, need
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("repro_torch.optim", "repro_torch.checkpoint.saver",
                "repro_torch.data.synthetic", "repro_torch.train.trainer",
                "repro_torch.kernels.ssd", "repro_torch.models.ssd",
                "repro_torch.kernels.flash_attention"):
        assert mod in names, mod


def test_federation_and_catalog_are_covered():
    """The federation's modules, the metrics catalog and the examples are
    among the files checked above, and the modules import in the blocked
    interpreter."""
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    mods = [f"federation/{m}.py" for m in ("__init__", "bridge", "cluster",
                                          "router", "site", "spillover")]
    for need in [*(f"src/repro_torch/{m}" for m in mods),
                 "src/repro_torch/obs/catalog.py",
                 *(f"examples/torch_{e}.py" for e in (
                     "knot_campaign", "quickstart", "serve_batch",
                     "train_ft"))]:
        assert need in rel, need
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = _PROBE.replace("print(len(names))", "print(' '.join(names))")
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for m in mods + ["obs/catalog.py"]:
        mod = "repro_torch." + m[:-3].replace("/", ".").replace(
            ".__init__", "")
        assert mod in names, mod


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card it exits non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
