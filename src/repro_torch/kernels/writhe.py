"""Gauss-linking writhe map: the CUDA kernel for Hopper and its plain
PyTorch version.

Port of ``repro/kernels/writhe.py::writhe_map`` (a Pallas TPU kernel). The
kernel is ``csrc/writhe.cu``, built by :mod:`repro_torch.kernels.build` and
called through ``ctypes``; its note says what bounds it and how it is laid
out. ``writhe_map_ref`` transcribes ``repro/kernels/ref.py::writhe_map_ref``.

W[b, i, j] is the signed solid angle of segment pair (i, j) over 2π; the
total writhe of subchain [a, b) is ``W[a:b, a:b].sum() / 2``, which is what
the knot screen and the knot-core scan in :mod:`repro_torch.apps.knots`
consume. :func:`writhe_map_sums` also returns each structure's total writhe
and ACN, summed in the kernel's launch (plain version:
:func:`writhe_sums_ref`).
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

TILE = 32  # outputs per tile side, as in csrc/writhe.cu
_count_lock = threading.Lock()
_lib = None


def _row_start(ti: int, tiles: int) -> int:
    return ti * tiles - ti * (ti - 1) // 2


def block_tile(blk: int, tiles: int) -> tuple[int, int, int]:
    """Block index -> (b, ti, tj), ti <= tj: the kernel's ``tile_pair`` with
    the batch folded in as ``writhe_kernel`` folds it (``blk = b * pairs +
    k``, ``pairs = tiles (tiles + 1) / 2``), the float32 root included."""
    pairs = tiles * (tiles + 1) // 2
    b, k = divmod(blk, pairs)
    d = 2 * tiles + 1
    disc = np.float32(d * d - 8 * k)
    ti = int((np.float32(d) - np.sqrt(disc)) * np.float32(0.5))
    while ti > 0 and _row_start(ti, tiles) > k:
        ti -= 1
    while _row_start(ti + 1, tiles) <= k:
        ti += 1
    return b, ti, ti + (k - _row_start(ti, tiles))


def _library() -> ctypes.CDLL:
    """The kernel's shared library, built and typed at first use."""
    global _lib
    if _lib is None:
        from .build import load
        lib = load("writhe")
        lib.writhe_map_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_void_p]
        lib.writhe_map_launch.restype = ctypes.c_int
        lib.writhe_map_sums_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.writhe_map_sums_launch.restype = ctypes.c_int
        lib.writhe_error_string.argtypes = [ctypes.c_int]
        lib.writhe_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(coords: torch.Tensor, name: str) -> None:
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (B, n, 3), got {tuple(coords.shape)}")
    if coords.device.type == "cpu":
        return
    if coords.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {coords.device}")
    if coords.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {coords.dtype}")
    if not coords.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")


def _launch(coords: torch.Tensor, sums: bool):
    """The kernel on a checked CUDA tensor: the map, and with ``sums`` the
    (B,) total writhe and ACN written by the same launch."""
    b, n, _ = coords.shape
    m = max(n - 1, 0)
    dev = coords.device
    if b == 0 or n < 3:
        # every pair lies on the |i - j| <= 1 band: nothing to launch
        zeros = torch.zeros(b, dtype=torch.float32, device=dev)
        return (torch.zeros((b, m, m), dtype=torch.float32, device=dev),
                zeros, zeros.clone())
    tiles = math.ceil(m / TILE)
    pairs = tiles * (tiles + 1) // 2
    if b * pairs > 2**31 - 1:
        raise ValueError(f"writhe_map grid too large for B={b}, n={n}")
    lib = _library()
    out = torch.empty((b, m, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if sums:
            # scratch: a (sum W, sum |W|) partial per tile pair, and a
            # ticket per structure that finds the block which sums them
            partial = torch.empty((b, pairs, 2), dtype=torch.float32,
                                  device=dev)
            tickets = torch.empty(b, dtype=torch.int32, device=dev)
            wr = torch.empty(b, dtype=torch.float32, device=dev)
            acn = torch.empty(b, dtype=torch.float32, device=dev)
            err = lib.writhe_map_sums_launch(
                coords.data_ptr(), out.data_ptr(), partial.data_ptr(),
                tickets.data_ptr(), wr.data_ptr(), acn.data_ptr(), b, n,
                stream)
        else:
            wr = acn = None
            err = lib.writhe_map_launch(coords.data_ptr(), out.data_ptr(), b,
                                        n, stream)
    if err:
        raise RuntimeError(f"writhe_map launch failed: CUDA error {err} "
                           f"({lib.writhe_error_string(err).decode()})")
    with _count_lock:
        writhe_map.launches += 1
    return out, wr, acn


def writhe_map(coords: torch.Tensor) -> torch.Tensor:
    """coords: (B, n, 3) float32 -> writhe map (B, n-1, n-1) float32.

    A CUDA tensor launches the hand-written kernel on the current stream
    (and counts the launch in ``writhe_map.launches``); a CPU tensor takes
    :func:`writhe_map_ref`. Anything else raises: there is no fallback."""
    _check(coords, "writhe_map")
    if coords.device.type == "cpu":
        return writhe_map_ref(coords)
    return _launch(coords, sums=False)[0]


writhe_map.launches = 0


def writhe_map_sums(coords: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """coords: (B, n, 3) float32 -> (total writhe (B,), ACN (B,), writhe map
    (B, n-1, n-1)), all float32: ``W.sum() / 2`` and ``|W|.sum() / 2`` per
    structure.

    A CUDA tensor launches the kernel once: the map and both sums come out
    of the same launch (partials per tile pair, summed in a fixed order by
    the last block of each structure, so the sums are the same bits on
    every call), counted in ``writhe_map.launches``. A CPU tensor takes :func:`writhe_sums_ref`."""
    _check(coords, "writhe_map_sums")
    if coords.device.type == "cpu":
        return writhe_sums_ref(coords)
    out, wr, acn = _launch(coords, sums=True)
    return wr, acn, out


def writhe_sums_ref(coords: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`writhe_map_sums`: :func:`writhe_map_ref`,
    then the two sums over the map."""
    w = writhe_map_ref(coords)
    wr = w.sum(dim=(1, 2)) / 2.0
    acn = torch.abs(w).sum(dim=(1, 2)) / 2.0
    return wr, acn, w


def writhe_map_ref(coords: torch.Tensor) -> torch.Tensor:
    """coords: (B, n, 3) -> (B, n-1, n-1) Gauss-integral writhe map
    (Klenin–Langowski method 1a), straightforward broadcast implementation."""
    p1 = coords[:, :-1, None, :]   # (B, i, 1, 3)
    p2 = coords[:, 1:, None, :]
    q1 = coords[:, None, :-1, :]   # (B, 1, j, 3)
    q2 = coords[:, None, 1:, :]
    r13 = q1 - p1
    r14 = q2 - p1
    r23 = q1 - p2
    r24 = q2 - p2

    def norm(x):
        return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)

    def cross(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.linalg.cross(a, b, dim=-1)

    n1 = norm(cross(r13, r14))
    n2 = norm(cross(r14, r24))
    n3 = norm(cross(r24, r23))
    n4 = norm(cross(r23, r13))

    def asin_dot(a, b):
        return torch.arcsin(torch.clamp((a * b).sum(-1), -1.0, 1.0))

    omega = (asin_dot(n1, n2) + asin_dot(n2, n3) +
             asin_dot(n3, n4) + asin_dot(n4, n1))
    sign = torch.sign((cross(q2 - q1, p2 - p1) * r13).sum(-1))
    w = omega * sign / (4.0 * math.pi) * 2.0
    nseg = w.shape[1]
    idx = torch.arange(nseg, device=coords.device)
    band = (idx[:, None] - idx[None, :]).abs() <= 1
    return torch.where(band, torch.zeros((), dtype=w.dtype,
                                         device=w.device), w)
