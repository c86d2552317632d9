"""Flash-decode: one query token per slot against a dense or a paged KV
cache — the CUDA kernels for Hopper and their plain PyTorch versions.

Port of ``repro/kernels/flash_decode.py``. The kernels are
``csrc/flash_decode.cu`` (two entry points, dense and paged), built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``; the note at
the top of the source says what bounds them and how they are laid out.
``flash_decode_ref`` and ``flash_decode_paged_ref`` transcribe the
reference's XLA twins ``flash_decode_xla`` and ``flash_decode_paged_xla``,
``bounded`` included.

The kernels split each slot's key range over the blocks of a thread-block
cluster and merge the blocks' partial softmax states by log-sum-exp in the
same launch. How many splits is :func:`split_plan`'s choice, a pure
function of shapes and the SM count. A KV head's query heads go to one
block in groups of at most ``GROUP_G`` (:func:`head_groups`), so a group
of up to ``MAX_G`` query heads per KV head takes one or two blocks.

The contract is the reference's. Ragged continuous batching is expressed by
positions: ``q_positions`` (B,) is each slot's decode position, and for the
dense cache ``k_positions`` (B, S) the position each cache row holds, with
-1 for invalid — dense prefixes, ring buffers, padded slots and empty lanes
in one encoding. For the paged cache a key's position is
``page_idx * page_size + offset`` and unbound table entries (-1) are masked.
A slot with no valid key gets exact zeros.

:func:`flash_decode` and :func:`flash_decode_paged` dispatch on the tensor's
device: a CUDA tensor launches the kernel (counted in ``.launches``) or
raises, a CPU tensor takes the plain version; there is no interpret
switch. After a launch the wrapper's ``.last_plan`` holds what it gave the
kernel: (splits, tiles or pages a split, grid). ``decode_attention`` and
``decode_attention_paged``, the names the model calls as in the reference,
are the same functions.

The dense kernel can also return each head's log-sum-exp (``return_lse``):
the sequence-parallel decode of the sharded serve step launches it on each
rank's slice of a sequence-sharded cache and merges the slices' outputs by
their log-sum-exps (:func:`merge_lse`, over stacked slices on one device
or over the ranks).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Callable

import torch

NEG_INF = -1e30
MAX_G, MAX_D = 16, 256      # as in csrc/flash_decode.cu
GROUP_G = 8                 # query heads a block takes, as in the source
TILE = 32                   # rows per tile, as in csrc/flash_decode.cu
BLOCKS_PER_SM = 4           # the split aims at this many blocks an SM
MAX_SPLIT = 16              # blocks in a cluster, as csrc/flash_decode.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
_lib = None
_sms: dict[int, int] = {}


def _library() -> ctypes.CDLL:
    """The kernels' shared library, built and typed at first use."""
    global _lib
    if _lib is None:
        from .build import load
        lib = load("flash_decode")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_decode_launch.argtypes = (
            [i32] + [ptr] * 7 + [i32] * 8 + [i64] * 6
            + [ctypes.c_float, i32, i32, i32, ptr])
        lib.flash_decode_launch.restype = i32
        lib.flash_decode_paged_launch.argtypes = (
            [i32] + [ptr] * 6 + [i32] * 9 + [i64] * 6
            + [ctypes.c_float, i32, i32, ptr])
        lib.flash_decode_paged_launch.restype = i32
        lib.flash_decode_error_string.argtypes = [i32]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _count(fn, plan: tuple[int, int, tuple[int, int, int]],
           attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel, given ``plan``, counted in
    ``fn.<attr>``."""
    with _count_lock:
        setattr(fn, attr, getattr(fn, attr) + 1)
        fn.last_plan = plan


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           name: str) -> tuple[int, int, int, int]:
    """Shapes the kernel takes; returns (B, H, K, G)."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{name}: q must be (B, 1, H, Dk), got "
                         f"{tuple(q.shape)}")
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"{name}: k and v must be 4-D with the same first "
                         f"three axes, got {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dk = q.shape
    kh = k.shape[2]
    if k.shape[3] != dk or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    return b, h, kh, h // kh


def _check_cuda(q, k, v, name: str) -> None:
    """What the CUDA kernel takes; raises on anything else."""
    if not (k.device == v.device == q.device):
        raise ValueError(f"{name}: q, k and v must be on one device")
    if q.dtype not in _DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"{name}: takes float32 or bfloat16 q, k and v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    g = q.shape[2] // k.shape[2]
    if g > MAX_G or k.shape[3] > MAX_D or v.shape[3] > MAX_D:
        raise ValueError(f"{name}: the kernel takes at most {MAX_G} query "
                         f"heads per KV head and head dims up to {MAX_D}, got "
                         f"G={g}, Dk={k.shape[3]}, Dv={v.shape[3]}")
    if k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{name}: the last axis of k and v must be "
                         f"contiguous")
    if q.shape[0] > 65535:
        raise ValueError(f"{name}: at most 65535 slots, got {q.shape[0]}")


def _vec(k: torch.Tensor, v: torch.Tensor) -> int:
    """1 when every K and V row may be read with 16-byte loads."""
    e = k.element_size()
    for t in (k, v):
        if t.data_ptr() % 16 or (t.shape[3] * e) % 16:
            return 0
        if any((t.stride(i) * e) % 16 for i in range(3)):
            return 0
    return 1


def _window(window: int | None) -> int:
    if window is None:
        return -1
    if window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    return int(window)


# ---------------------------------------------------------------------------
# the split over blocks
# ---------------------------------------------------------------------------


def head_groups(g: int) -> int:
    """Blocks a KV head's ``g`` query heads take, as the kernel cuts them:
    groups of at most ``GROUP_G`` heads."""
    return -(-g // GROUP_G)


def even_split(n_units: int, n: int) -> tuple[int, int]:
    """``n_units`` units in at most ``n`` runs of equal length but the last:
    returns (runs, units per run), no run empty."""
    per = -(-n_units // max(1, min(n, n_units)))
    return -(-n_units // per), per


@functools.lru_cache(maxsize=256)
def split_plan(n_units: int, unit_rows: int, pairs: int,
               n_sm: int) -> tuple[int, int]:
    """How the kernels split each (slot, KV head)'s key rows over blocks:
    returns (n_split, units per split).

    A unit is a tile of ``TILE`` rows (dense cache: ``ceil(S / TILE)``
    units) or a page of ``unit_rows`` rows (paged: ``n_pages`` units, so
    splits fall on page boundaries). ``pairs`` is B * K times the head
    groups (:func:`head_groups`): the blocks before splitting. It aims at
    ``BLOCKS_PER_SM * n_sm`` blocks, splits no further than about a tile a
    block and no more than ``MAX_SPLIT`` ways (a cluster), and does not
    split where the pairs alone reach that. It reads only shapes, never
    positions, so the wrapper needs nothing back from the card."""
    if n_units < 1 or pairs < 1:
        return 1, max(n_units, 1)
    want = -(-BLOCKS_PER_SM * n_sm // pairs)
    min_units = -(-TILE // unit_rows)
    return even_split(n_units, min(want, MAX_SPLIT,
                                   -(-n_units // min_units)))


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device.index] = n
    return n


def _plan(device: torch.device, n_units: int, unit_rows: int,
          pairs: int) -> tuple[int, int]:
    return split_plan(n_units, unit_rows, pairs, _sm_count(device))


def _launch(fn_name: str, args: list) -> None:
    lib = _library()
    err = getattr(lib, fn_name)(*args)
    if err:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.flash_decode_error_string(err).decode()})")


# ---------------------------------------------------------------------------
# dense cache
# ---------------------------------------------------------------------------


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_positions: torch.Tensor,
                 k_positions: torch.Tensor | None = None, *,
                 window: int | None = None, block_k: int = 128,
                 scale: float | None = None,
                 bounded: bool = True, return_lse: bool = False):
    """q: (B, 1, H, Dk); k: (B, S, K, Dk); v: (B, S, K, Dv) -> (B, 1, H, Dv)
    in q's dtype; with ``return_lse``, (out, lse), lse (B, 1, H) float32:
    each head's log-sum-exp of its attended scores (natural units), -inf
    where it attends no key (and out is zeros there).

    ``q_positions``: (B,) int absolute position of each slot's query.
    ``k_positions``: (B, S) int cache-row positions, -1 = invalid; defaults
    to ``arange(S)``. ``bounded`` (only when row index == position, i.e.
    not a ring or a sequence shard) stops at the tile that holds the
    query's position. ``block_k`` is the plain version's block; the
    kernel's tile is its own. A launch with ``return_lse`` is counted in
    ``flash_decode.lse_launches``, the others in ``.launches``; a ``meta``
    tensor takes the plain version (shapes only, for counting operations)
    and launches nothing.
    """
    b, h, kh, g = _check(q, k, v, "flash_decode")
    dev = q.device
    if dev.type in ("cpu", "meta"):
        return flash_decode_ref(q, k, v, q_positions, k_positions,
                                window=window, block_k=block_k, scale=scale,
                                bounded=bounded and dev.type == "cpu",
                                return_lse=return_lse)
    if dev.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {dev}")
    _check_cuda(q, k, v, "flash_decode")
    s, dk, dv = k.shape[1], k.shape[3], v.shape[3]
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, 1, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    if b == 0 or s == 0:
        out.zero_()
        return (out, lse.fill_(-math.inf)) if return_lse else out
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    q = q.contiguous()
    qp = q_positions.to(device=dev, dtype=torch.int32).contiguous()
    if k_positions is None:
        kp = torch.arange(s, dtype=torch.int32,
                          device=dev).expand(b, s).contiguous()
    else:
        kp = k_positions.to(device=dev, dtype=torch.int32).contiguous()
    if qp.shape != (b,) or kp.shape != (b, s):
        raise ValueError(f"flash_decode: positions {tuple(qp.shape)}, "
                         f"{tuple(kp.shape)} do not fit B={b}, S={s}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        gh = head_groups(g)
        n, per = _plan(dev, -(-s // TILE), TILE, b * kh * gh)
        _launch("flash_decode_launch", [
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            b, s, kh, g, dk, dv, per * TILE, n, *k.stride()[:3],
            *v.stride()[:3], float(scale), _window(window), int(bounded),
            _vec(k, v), stream])
    _count(flash_decode, (n, per, (n, kh * gh, b)),
           "lse_launches" if return_lse else "launches")
    return (out, lse) if return_lse else out


flash_decode.launches = 0
flash_decode.lse_launches = 0
flash_decode.last_plan = None


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor,
                     k_positions: torch.Tensor | None = None, *,
                     window: int | None = None, block_k: int = 128,
                     scale: float | None = None,
                     bounded: bool = True, return_lse: bool = False):
    """Plain version of :func:`flash_decode`: the split-KV online softmax of
    the reference's ``flash_decode_xla``, block by block. ``bounded`` runs
    ``ceil((max(q_positions) + 1) / block_k)`` blocks instead of all.
    ``return_lse`` adds each head's log-sum-exp, ``m + log(l)`` of the
    final statistics, -inf where ``l = 0``."""
    b, sq, h, dk = q.shape
    assert sq == 1
    _, s, kh, _ = k.shape
    dv = v.shape[-1]
    g = h // kh
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    dev = q.device
    if k_positions is None:
        k_positions = torch.arange(s, dtype=torch.int32,
                                   device=dev).expand(b, s)
    k_positions = k_positions.to(dev, torch.int32)
    block_k = min(block_k, s)
    pad = (-s) % block_k
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad),
                                              value=-1)
    n_k = (s + pad) // block_k
    qp = q_positions.to(dev, torch.int32)
    qh = q[:, 0].reshape(b, kh, g, dk).float()
    if bounded and b:
        n_live = min(max((int(qp.max()) + block_k) // block_k, 0), n_k)
    else:
        n_live = n_k if b else 0

    m_run = torch.full((b, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kh, g, dv), dtype=torch.float32, device=dev)
    for i in range(n_live):
        blk = slice(i * block_k, (i + 1) * block_k)
        kp = k_positions[:, blk]
        mask = (kp >= 0) & (kp <= qp[:, None])
        if window is not None:
            mask &= kp > qp[:, None] - window
        m_run, l_run, acc = _online_softmax_block(
            qh, k[:, blk].float(), v[:, blk].float(), mask, scale,
            m_run, l_run, acc)
    out = acc / torch.clamp_min(l_run[..., None], 1e-37)
    out = out.reshape(b, 1, h, dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l_run > 0, m_run + torch.log(l_run),
                      torch.full_like(l_run, -math.inf))
    return out, lse.reshape(b, 1, h)


def _online_softmax_block(qh, kc, vc, mask, scale, m_run, l_run, acc):
    """One block of the reference's loop body: qh (B, K, G, Dk) fp32, kc
    (B, C, K, Dk), vc (B, C, K, Dv), mask (B, C)."""
    sc = torch.einsum("bkgd,bckd->bkgc", qh, kc) * scale
    mask = mask[:, None, None, :]
    sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
    m_new = torch.maximum(m_run, sc.amax(dim=-1))
    # mask p explicitly: in an all-invalid block m_new stays NEG_INF and
    # exp(NEG_INF - NEG_INF) = 1 would attend uniformly to garbage
    p = torch.where(mask, torch.exp(sc - m_new[..., None]),
                    torch.zeros_like(sc))
    corr = torch.exp(m_run - m_new)
    l_new = l_run * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgc,bckd->bkgd", p, vc)
    return m_new, l_new, acc * corr[..., None] + pv


# the reference's dispatch name: the wrapper already dispatches on device
decode_attention = flash_decode


def lse_weights(lse: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``exp(lse - m)``: a partial's weight against the max ``m`` of the
    partials' log-sum-exps; a partial with no attended key (``lse = -inf``)
    weighs 0, also where every partial is empty (``m = -inf``, which would
    give ``exp(-inf + inf) = nan``)."""
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.exp(lse - m)


def merge_lse(outs: torch.Tensor, lses: torch.Tensor, amax: Callable,
              total: Callable) -> torch.Tensor:
    """The attention over the union of disjoint key ranges from each
    range's (out, lse) -> (B, 1, H, Dv) float32: one max of the lses
    (``amax``), then one sum (``total``) of the weights ``exp(lse - max)``
    and one of the weighted outputs, the weights' sum clamped at 1e-37 as
    the reference clamps it. The sequence-parallel decode island
    (:meth:`repro_torch.sharding.DistContext.decode_attention`) passes the
    max and sum over the ``model`` ranks, each rank holding one range;
    ranges stacked on dim 0 of one tensor take ``amax(0)`` and ``sum(0)``."""
    w = lse_weights(lses, amax(lses))
    o = total(outs.float() * w[..., None])
    return o / torch.clamp_min(total(w), 1e-37)[..., None]


# ---------------------------------------------------------------------------
# paged cache
# ---------------------------------------------------------------------------


def flash_decode_paged(q: torch.Tensor, pool_k: torch.Tensor,
                       pool_v: torch.Tensor, q_positions: torch.Tensor,
                       page_table: torch.Tensor, *,
                       window: int | None = None,
                       scale: float | None = None) -> torch.Tensor:
    """q: (B, 1, H, Dk); pool_k: (P, page_size, K, Dk); pool_v likewise with
    Dv; page_table: (B, pages_per_slot) int, -1 = unbound (page 0 is the
    allocator's trash page) -> (B, 1, H, Dv) in q's dtype.

    A CUDA tensor launches the paged kernel, which reads each slot's table
    row itself and stops at the page that holds the query's position; a
    CPU tensor takes :func:`flash_decode_paged_ref`."""
    b, h, kh, g = _check(q, pool_k, pool_v, "flash_decode_paged")
    dev = q.device
    if dev.type in ("cpu", "meta"):
        return flash_decode_paged_ref(q, pool_k, pool_v, q_positions,
                                      page_table, window=window, scale=scale,
                                      bounded=dev.type == "cpu")
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_paged runs on cuda or cpu, not "
                         f"{dev}")
    _check_cuda(q, pool_k, pool_v, "flash_decode_paged")
    page_size, dk, dv = pool_k.shape[1], pool_k.shape[3], pool_v.shape[3]
    out = torch.empty((b, 1, h, dv), dtype=q.dtype, device=dev)
    n_pages = page_table.shape[-1] if page_table.dim() == 2 else 0
    if b == 0 or n_pages == 0:
        return out.zero_()
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    q = q.contiguous()
    qp = q_positions.to(device=dev, dtype=torch.int32).contiguous()
    table = page_table.to(device=dev, dtype=torch.int32).contiguous()
    if qp.shape != (b,) or table.shape[0] != b:
        raise ValueError(f"flash_decode_paged: positions {tuple(qp.shape)} "
                         f"and table {tuple(table.shape)} do not fit B={b}")
    if page_size * n_pages > 2**31 - 1:
        raise ValueError("flash_decode_paged: pages_per_slot * page_size "
                         "must fit in 32 bits")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        gh = head_groups(g)
        n, per = _plan(dev, n_pages, page_size, b * kh * gh)
        _launch("flash_decode_paged_launch", [
            _DTYPES[q.dtype], q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), qp.data_ptr(), table.data_ptr(),
            out.data_ptr(), b, kh, g, dk, dv, page_size, n_pages,
            per, n, *pool_k.stride()[:3], *pool_v.stride()[:3],
            float(scale), _window(window), _vec(pool_k, pool_v), stream])
    _count(flash_decode_paged, (n, per, (n, kh * gh, b)))
    return out


flash_decode_paged.launches = 0
flash_decode_paged.last_plan = None


def flash_decode_paged_ref(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, q_positions: torch.Tensor,
                           page_table: torch.Tensor, *,
                           window: int | None = None,
                           scale: float | None = None,
                           bounded: bool = True) -> torch.Tensor:
    """Plain version of :func:`flash_decode_paged`: the reference's
    ``flash_decode_paged_xla``, one logical page per block, gathering that
    page of every slot; ``bounded`` stops after the page that holds
    ``max(q_positions)``."""
    b, sq, h, dk = q.shape
    assert sq == 1
    _, page_size, kh, _ = pool_k.shape
    dv = pool_v.shape[-1]
    g = h // kh
    n_pages = page_table.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(dk)
    dev = q.device
    qp = q_positions.to(dev, torch.int32)
    qh = q[:, 0].reshape(b, kh, g, dk).float()
    table = page_table.to(dev, torch.int32)
    if bounded and b:
        n_live = min(max((int(qp.max()) + page_size) // page_size, 0),
                     n_pages)
    else:
        n_live = n_pages if b else 0
    offs = torch.arange(page_size, dtype=torch.int32, device=dev)

    m_run = torch.full((b, kh, g), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((b, kh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kh, g, dv), dtype=torch.float32, device=dev)
    for i in range(n_live):
        pages = table[:, i]
        phys = torch.clamp_min(pages, 0).long()
        kp = (i * page_size + offs)[None, :]
        mask = (pages >= 0)[:, None] & (kp <= qp[:, None])
        if window is not None:
            mask &= kp > qp[:, None] - window
        m_run, l_run, acc = _online_softmax_block(
            qh, pool_k[phys].float(), pool_v[phys].float(), mask, scale,
            m_run, l_run, acc)
    out = acc / torch.clamp_min(l_run[..., None], 1e-37)
    return out.reshape(b, 1, h, dv).to(q.dtype)


decode_attention_paged = flash_decode_paged
