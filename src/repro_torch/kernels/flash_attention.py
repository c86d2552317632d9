"""Whole-sequence GQA flash attention: the CUDA kernel for Hopper, its plain
PyTorch version, and the autograd function that trains through it.

Port of ``repro/kernels/flash_attention.py`` (the Pallas kernel
``flash_attention``): causal, sliding-window or bidirectional attention over
(B, Sq, H, D) queries and (B, Sk, K, D) keys and values, H % K == 0, with a
static ``q_offset`` (the absolute position of query 0). ``block_q``,
``block_k`` and ``interpret`` are the TPU's and are not carried over. The
kernel is ``csrc/flash_attention.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``; the note at
the top of the source says what bounds it and how it is laid out.

:func:`flash_attention` dispatches on the tensor's device: a CUDA tensor
runs :class:`FlashAttentionFn`, whose forward launches the kernel (counted
in ``flash_attention.launches``) or raises, and whose backward recomputes
:func:`flash_attention_plain` with differentiable PyTorch ops and takes its
gradients. The JAX package has no backward kernel either: its training
differentiates the model's ``chunked_attention``. A CPU tensor takes
:func:`flash_attention_plain` directly.

The plain version is the model's own
:func:`repro_torch.models.attention.chunked_attention`, called with the
model's ``kv_chunk`` and ``score_dtype`` (and so its banded path for
whole-sequence local layers): that is what the JAX model computes, and the
JAX ``ref.attention_ref`` delegates to it too. Like the Pallas kernel, the
kernel takes one head dim for Q, K and V and float32 scores.

One difference, by contract: a query with no valid key (all its keys
masked) gets exact zeros from the kernel, as from the flash-decode kernels;
``chunked_attention`` and the Pallas kernel give an average over masked
keys there. No whole-sequence model call produces such a query.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the kernel's head dims
MAX_G = 64                               # query heads per KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's shared library, built and typed at first use."""
    global _lib
    if _lib is None:
        from .build import load
        lib = load("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [i32] + [ptr] * 4 + [i32] * 6 + [i64] * 9
            + [ctypes.c_float] + [i32] * 4 + [ptr])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset: int = 0, kv_chunk: int = 1024,
                          score_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: the model's
    ``chunked_attention`` at ``kv_chunk`` (differentiable)."""
    from repro_torch.models.attention import chunked_attention
    return chunked_attention(q, k, v, q_offset=q_offset, causal=causal,
                             window=window, kv_chunk=kv_chunk,
                             score_dtype=score_dtype)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _count() -> None:
    with _count_lock:
        flash_attention.launches += 1


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` with a contiguous last axis (the kernel reads rows in place
    through the other strides); a copy only when the last axis is
    strided."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: {name} must be float32 or "
                        f"bfloat16, got {t.dtype}")
    return t


def _vec(*tensors: torch.Tensor) -> int:
    """1 when every row of every tensor may be read with 16-byte loads."""
    for t in tensors:
        e = t.element_size()
        if t.data_ptr() % 16 or (t.shape[-1] * e) % 16:
            return 0
        if any((t.stride(i) * e) % 16 for i in range(t.dim() - 1)):
            return 0
    return 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k and v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, Sk, K, D) with q's "
                         f"B and D, q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads on "
                         f"{k.shape[2]} KV heads")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int | None, q_offset: int) -> torch.Tensor:
    """Run the kernel: (B, Sq, H, D) in q's dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if d not in HEAD_DIMS or h // kh > MAX_G:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS} and at most {MAX_G} query heads per "
                         f"KV head, got D={d}, G={h // kh}")
    if sk == 0 or q_offset < 0:
        raise ValueError(f"flash_attention: needs Sk >= 1 and q_offset >= "
                         f"0, got Sk={sk}, q_offset={q_offset}")
    q, k, v = _rows(q, "q"), _rows(k, "k"), _rows(v, "v")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k and v must share a dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    if b * sq == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, sk, h, kh, d, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], 1.0 / math.sqrt(d),
            int(causal), 0 if window is None else int(window), int(q_offset),
            _vec(q, k, v), stream)
    if err:
        raise RuntimeError(f"flash_attention_launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    _count()
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: :func:`flash_attention_plain`
    recomputed with differentiable ops at ``kv_chunk``, and its gradients
    for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_chunk):
        out = _launch(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_chunk=kv_chunk)
        return out

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip(ctx.saved_tensors, needs)]
            out = flash_attention_plain(*ins, **ctx.args)
            wrt = [t for t, need in zip(ins, needs) if need]
            got = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        return (*[next(got) if need else None for need in needs],
                None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, kv_chunk: int = 1024,
                    score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D), H % K == 0 -> (B, Sq, H, D) in
    q's dtype. ``window``: keys with position > q_pos - window only;
    ``q_offset``: the absolute position of query 0 (keys sit at 0..Sk-1).

    A CUDA tensor launches the kernel through :class:`FlashAttentionFn`
    (float32 scores only; ``kv_chunk`` is the chunk of the backward's
    recomputation); a CPU tensor takes :func:`flash_attention_plain` at
    ``kv_chunk`` and ``score_dtype``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_chunk=kv_chunk,
                                     score_dtype=score_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if score_dtype != torch.float32:
        raise ValueError(f"flash_attention: the kernel computes float32 "
                         f"scores, got score_dtype {score_dtype}")
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset, kv_chunk)


flash_attention.launches = 0
