"""Sharded, checksummed, async checkpointing. Port of
``repro/checkpoint/saver.py``, in the reference's format, so a checkpoint
written by either package restores in the other.

Layout (one directory per step, atomically renamed into place):

    <dir>/ckpt_<step>/
        manifest.json       # per-leaf name/shape/dtype/shard/offset/crc
        shard_00000.bin.zst # concatenated leaf buffers, compressed

The manifest has the reference's keys (``step``, ``extra``, ``leaves``,
``format``, ``codec``) and its leaf names: the ``jax.tree_util.keystr`` of
each leaf (:func:`repro_torch.tree.paths`), so a ``TrainState`` writes
``[<flat index 0>]['embed']['embedding']`` and so on, in the same order.
Each leaf's buffer is its raw little-endian bytes; a bfloat16 leaf is
written as its 2-byte words with dtype ``"bfloat16"`` (the name numpy takes
with ``ml_dtypes``, which the port does not need). Shards are compressed
with zstd when ``zstandard`` is installed, else zlib, and the manifest
records which.

Unlike the reference, the shards of one checkpoint are compressed (and on
restore decompressed) in parallel threads; the files are the same.

Writes go to ``.tmp-ckpt_<step>`` and rename on success, so a crash
mid-save never corrupts the latest checkpoint. ``async_save`` copies the
tree to host memory before it returns, then serializes on a background
thread; the returned handle joins and re-raises. Restore takes a ``like``
tree (tensors, ``meta`` tensors included) and puts each leaf in the like
leaf's dtype on its device, or on ``device`` when one is given.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.tree import paths, unflatten_as

try:
    import zstandard
except ImportError:  # a host may lack zstandard: fall back to zlib.
    zstandard = None

_SHARD_TARGET_BYTES = 128 * 1024 * 1024
# shards are compressed and decompressed on this many threads (zlib and
# zstandard release the GIL); the bytes on disk are the same as one thread's
_WORKERS = min(8, os.cpu_count() or 1)
_BF16 = "bfloat16"


class _Codec:
    """Shard compression, selected per checkpoint and recorded in the
    manifest so restores pick the matching decompressor regardless of which
    codec the writing process had available."""

    def __init__(self, name: str, level: int = 3):
        if name == "zstd" and zstandard is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstd but the zstandard module "
                "is not installed; re-save with the zlib codec or install "
                "zstandard")
        self.name = name
        self._level = level

    @classmethod
    def preferred(cls) -> "_Codec":
        return cls("zstd" if zstandard is not None else "zlib")

    def compress(self, data: bytes) -> bytes:
        if self.name == "zstd":
            return zstandard.ZstdCompressor(level=self._level).compress(data)
        return zlib.compress(data, self._level)

    def decompress(self, data: bytes) -> bytes:
        if self.name == "zstd":
            return zstandard.ZstdDecompressor().decompress(
                data, max_output_size=2 ** 34)
        return zlib.decompress(data)


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array; bfloat16 as its uint16 words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any, arr: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return _BF16
    return str(arr.dtype)


def save_checkpoint(directory: str | os.PathLike, step: int, tree: Any,
                    *, extra: dict | None = None) -> str:
    """Synchronous save; returns the checkpoint path."""
    directory = Path(directory)
    final = directory / f"ckpt_{step:08d}"
    tmp = directory / f".tmp-ckpt_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    cctx = _Codec.preferred()
    manifest: dict = {"step": int(step), "extra": extra or {}, "leaves": [],
                      "format": 1, "codec": cctx.name}
    shard_idx = 0
    shard_buf: list[bytes] = []
    shard_bytes = 0
    pool = ThreadPoolExecutor(max_workers=_WORKERS)
    writes = []

    def write(i: int, raw: bytes) -> None:
        (tmp / f"shard_{i:05d}.bin.zst").write_bytes(cctx.compress(raw))

    def flush():
        nonlocal shard_idx, shard_buf, shard_bytes
        if not shard_buf:
            return
        writes.append(pool.submit(write, shard_idx, b"".join(shard_buf)))
        shard_idx += 1
        shard_buf = []
        shard_bytes = 0

    for name, leaf in paths(tree):
        arr = _host(leaf)
        buf = arr.tobytes()
        manifest["leaves"].append({
            "name": name, "shape": list(arr.shape),
            "dtype": _dtype_name(leaf, arr),
            "shard": shard_idx, "offset": shard_bytes, "nbytes": len(buf),
            "crc": zlib.crc32(buf) & 0xFFFFFFFF,
        })
        shard_buf.append(buf)
        shard_bytes += len(buf)
        if shard_bytes >= _SHARD_TARGET_BYTES:
            flush()
    flush()
    with pool:
        for w in writes:
            w.result()
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def _to_tensor(raw: bytes, entry: dict) -> torch.Tensor:
    if entry["dtype"] == _BF16:
        arr = np.frombuffer(raw, dtype=np.uint16).reshape(entry["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(entry["dtype"])).reshape(
        entry["shape"])
    return torch.from_numpy(arr.copy())


def restore_checkpoint(path: str | os.PathLike, tree_like: Any, *,
                       device: str | torch.device | None = None
                       ) -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like``: each leaf in the like
    leaf's dtype, on ``device`` if given, else on the like leaf's device
    (a ``meta`` like tree needs ``device``). Returns (tree, manifest
    extra)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    by_name = {e["name"]: e for e in manifest["leaves"]}
    dctx = _Codec(manifest.get("codec", "zstd"))
    like_paths = paths(tree_like)
    for name, _ in like_paths:
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
    needed = sorted({by_name[n]["shard"] for n, _ in like_paths})
    with ThreadPoolExecutor(max_workers=_WORKERS) as pool:
        shards = dict(zip(needed, pool.map(
            lambda i: dctx.decompress(
                (path / f"shard_{i:05d}.bin.zst").read_bytes()), needed)))

    out = []
    for name, like in like_paths:
        e = by_name[name]
        raw = shards[e["shard"]][e["offset"]: e["offset"] + e["nbytes"]]
        if (zlib.crc32(raw) & 0xFFFFFFFF) != e["crc"]:
            raise IOError(f"checksum mismatch for {name}")
        val = _to_tensor(raw, e)
        if tuple(val.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{tuple(val.shape)} vs {tuple(like.shape)}")
        dev = torch.device(device) if device is not None else like.device
        if dev.type == "meta":
            raise ValueError("restore_checkpoint: a meta like tree needs "
                             "device=")
        out.append(val.to(device=dev, dtype=like.dtype))
    return unflatten_as(tree_like, out), manifest.get("extra", {})


class _AsyncHandle:
    def __init__(self, thread: threading.Thread, box: dict):
        self._t = thread
        self._box = box

    def result(self, timeout: float | None = None) -> str:
        self._t.join(timeout)
        if self._t.is_alive():
            raise TimeoutError("checkpoint save still running")
        if "error" in self._box:
            raise self._box["error"]
        return self._box["path"]


class CheckpointManager:
    """Directory of step checkpoints with retention + async save + latest().

    ``on_save`` hook lets the trainer announce new checkpoints on the broker
    (the MonitorAgent keeps the checkpoint registry)."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3,
                 on_save=None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.on_save = on_save
        self._lock = threading.Lock()

    def steps(self) -> list[int]:
        out = []
        for p in self.directory.glob("ckpt_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest(self) -> tuple[int, str] | None:
        s = self.steps()
        if not s:
            return None
        return s[-1], str(self.directory / f"ckpt_{s[-1]:08d}")

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.directory / f"ckpt_{s:08d}",
                          ignore_errors=True)

    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> str:
        with self._lock:
            path = save_checkpoint(self.directory, step, tree, extra=extra)
            self._gc()
        if self.on_save:
            self.on_save(step, path)
        return path

    def async_save(self, step: int, tree: Any, *,
                   extra: dict | None = None) -> _AsyncHandle:
        # snapshot to host BEFORE returning so the caller may mutate state
        host = [leaf.detach().to("cpu", copy=True)
                if isinstance(leaf, torch.Tensor) else leaf
                for _, leaf in paths(tree)]
        host_tree = unflatten_as(tree, host)
        box: dict = {}

        def work():
            try:
                box["path"] = self.save(step, host_tree, extra=extra)
            except Exception as exc:  # noqa: BLE001
                box["error"] = exc

        t = threading.Thread(target=work, daemon=True,
                             name=f"ckpt-save-{step}")
        t.start()
        return _AsyncHandle(t, box)

    def restore_latest(self, tree_like: Any, *,
                       device: str | torch.device | None = None):
        latest = self.latest()
        if latest is None:
            return None
        step, path = latest
        tree, extra = restore_checkpoint(path, tree_like, device=device)
        return step, tree, extra
