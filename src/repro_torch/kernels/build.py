"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, for Hopper only (``sm_90a``). The build runs at first use; the
file name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Worker slots run tasks on
threads, so each source's build is serialised by its own lock (two sources
build in parallel) and written to a temporary path that is then renamed
into place (atomic against other processes too).

Nothing here runs at import, so every module of the port imports on a
machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_locks_guard = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float     # 0.0 when an up-to-date library was found
    log: str           # nvcc's output (ptxas register/spill report)


def nvcc() -> str:
    """Path of ``nvcc`` on PATH."""
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found on PATH: the CUDA kernels of "
                           "repro_torch are built from source and need the "
                           "CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    with _lock(name):
        return _build_locked(name)


def _build_locked(name: str) -> BuildResult:
    out = library_path(name)
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}.cu:\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, seconds, log)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock(name):
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build_locked(name).path))
            _loaded[name] = lib
        return lib
