"""Whole-sequence GQA flash attention: the CUDA kernels for Hopper (forward
and backward), their plain PyTorch versions, and the autograd function that
trains through them.

Port of ``repro/kernels/flash_attention.py`` (the Pallas kernel
``flash_attention``): causal, sliding-window or bidirectional attention over
(B, Sq, H, D) queries and (B, Sk, K, D) keys and values, H % K == 0, with a
static ``q_offset`` (the absolute position of query 0). ``block_q``,
``block_k`` and ``interpret`` are the TPU's and are not carried over. The
kernels are ``csrc/flash_attention.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``; the note at
the top of the source says what bounds them and how they are laid out.

:func:`flash_attention` dispatches on the tensor's device: a CUDA tensor
runs :class:`FlashAttentionFn`, whose forward launches the forward kernel
(counted in ``flash_attention.launches``, and also in
``flash_attention.wgmma_launches`` where it is the Hopper design: bf16 with
D <= 128), which also writes the rows' log-sum-exp, and whose backward
launches the backward kernel (counted in ``flash_attention.bwd_launches``);
each raises if its kernel cannot run.
The JAX package has no backward kernel: its training differentiates the
model's ``chunked_attention``. A CPU tensor takes
:func:`flash_attention_plain` directly and trains by autograd through it.

The plain versions: :func:`flash_attention_plain` is the model's own
:func:`repro_torch.models.attention.chunked_attention`, called with the
model's ``kv_chunk`` and ``score_dtype`` (and so its banded path for
whole-sequence local layers): that is what the JAX model computes, and the
JAX ``ref.attention_ref`` delegates to it too.
:func:`flash_attention_lse_plain` is the masked log-sum-exp of the scaled
scores, and :func:`flash_attention_bwd_plain` the backward's formula, both
chunk by chunk in float32. Like the Pallas kernel, the kernels take one head
dim for Q, K and V and float32 scores.

One difference, by contract: a query with no valid key (all its keys
masked) gets exact zeros (and lse = -inf, and zero gradients) from the
kernels, as from the flash-decode kernels; ``chunked_attention`` and the
Pallas kernel give an average over masked keys there. No whole-sequence
model call produces such a query.

Numerics of the backward. In float32 it is the exact gradient of the
forward, to round-off: Delta = rowsum(dO o out) equals rowsum(P o dP). In
bf16 the forward rounds p to bf16 before p.V, so out differs from P V by
bf16 round-off, and so does the kernel's dS from autograd through the plain
version; dV uses the rounded p, as autograd through the cast does, and dS
is rounded to bf16 before the dK and dQ products.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from repro_torch.obs.trace import span

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the kernel's head dims
MAX_G = 64                               # query heads per KV head
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the forward kernels (csrc/flash_attention.cu): the fp32 FMA design, mma.sync
# on the tensor cores, the Hopper design (wgmma, TMA, warp-specialised)
_DESIGNS = {"fma": 0, "mma": 1, "wgmma": 2}
_count_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' shared library, built and typed at first use."""
    global _lib
    if _lib is None:
        from .build import load
        lib = load("flash_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = (
            [i32] + [ptr] * 5 + [i32] * 6 + [i64] * 9
            + [ctypes.c_float] + [i32] * 5 + [ptr])
        lib.flash_attention_launch.restype = i32
        lib.flash_attention_bwd_launch.argtypes = (
            [i32] + [ptr] * 11 + [i32] * 6 + [i64] * 9
            + [ctypes.c_float] + [i32] * 4 + [ptr])
        lib.flash_attention_bwd_launch.restype = i32
        lib.flash_attention_bwd_workspace.argtypes = [i32] * 7
        lib.flash_attention_bwd_workspace.restype = i64
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          q_offset: int = 0, kv_chunk: int = 1024,
                          score_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain version of the forward's output: the model's
    ``chunked_attention`` at ``kv_chunk`` (differentiable)."""
    from repro_torch.models.attention import chunked_attention
    return chunked_attention(q, k, v, q_offset=q_offset, causal=causal,
                             window=window, kv_chunk=kv_chunk,
                             score_dtype=score_dtype)


def _chunks(q: torch.Tensor, k: torch.Tensor, *, causal: bool,
            window: int | None, q_offset: int, kv_chunk: int):
    """For each chunk of keys: its slice, the float32 scaled scores
    (B, Sq, K, G, C) and the (Sq, C) mask of valid (query, key) pairs."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    qh = q.float().reshape(b, sq, kh, h // kh, d)
    qp = q_offset + torch.arange(sq, device=q.device)[:, None]
    c = max(1, min(kv_chunk, sk))
    for k0 in range(0, sk, c):
        blk = slice(k0, min(k0 + c, sk))
        kp = torch.arange(blk.start, blk.stop, device=q.device)[None, :]
        mask = torch.ones((sq, kp.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kp <= qp)
        if window is not None:
            mask = mask & (kp > qp - window)
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, k[:, blk].float()) \
            / math.sqrt(d)
        yield blk, s, mask[None, :, None, None, :]


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              q_offset: int = 0, kv_chunk: int = 1024
                              ) -> torch.Tensor:
    """Plain version of the forward's second output: the log-sum-exp of
    each row's valid scaled scores, (B, H, Sq) float32, -inf for a row with
    no valid key."""
    b, sq, h, _ = q.shape
    kh = k.shape[2]
    lse = torch.full((b, sq, kh, h // kh), -math.inf, device=q.device)
    for _, s, mask in _chunks(q, k, causal=causal, window=window,
                              q_offset=q_offset, kv_chunk=kv_chunk):
        s = torch.where(mask, s, -math.inf)
        lse = torch.logaddexp(lse, torch.logsumexp(s, dim=-1))
    return lse.reshape(b, sq, h).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, g: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              q_offset: int = 0, kv_chunk: int = 1024
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of the backward kernel: dq, dk, dv in the inputs'
    dtype from the forward's ``out`` and ``lse`` and the output's gradient
    ``g``, by the explicit formula in float32, one chunk of keys at a time:
    P = exp(scale S - lse) on the valid pairs, Delta = rowsum(g o out),
    dV = P^T g, dS = P o (g V^T - Delta), dQ = scale dS K, dK = scale dS^T
    Q (summed over each KV head's group)."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    grp = h // kh
    scale = 1.0 / math.sqrt(d)
    qh = q.float().reshape(b, sq, kh, grp, d)
    gh = g.float().reshape(b, sq, kh, grp, d)
    delta = (gh * out.float().reshape(b, sq, kh, grp, d)).sum(-1)
    lse_h = lse.float().transpose(1, 2).reshape(b, sq, kh, grp)
    dq = torch.zeros_like(qh)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for blk, s, mask in _chunks(q, k, causal=causal, window=window,
                                q_offset=q_offset, kv_chunk=kv_chunk):
        p = torch.where(mask, torch.exp(s - lse_h[..., None]), 0.0)
        dv[:, blk] = torch.einsum("bqkgc,bqkgd->bckd", p, gh)
        dp = torch.einsum("bqkgd,bckd->bqkgc", gh, v[:, blk].float())
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bqkgc,bckd->bqkgd", ds, k[:, blk].float()) * scale
        dk[:, blk] = torch.einsum("bqkgc,bqkgd->bckd", ds, qh) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _count(*names: str) -> None:
    with _count_lock:
        for name in names:
            setattr(flash_attention, name, getattr(flash_attention, name) + 1)


def _forward_design(q: torch.Tensor, fma: bool = False) -> str:
    """The forward kernel for q's dtype and head dim: ``"wgmma"``, the
    Hopper design, for bf16 with D <= 128; ``"mma"`` (mma.sync) for bf16
    with D = 256; ``"fma"`` for float32, or when ``fma`` asks for it."""
    if fma or q.dtype != torch.bfloat16:
        return "fma"
    return "wgmma" if q.shape[-1] <= 128 else "mma"


def _tma_ok(t: torch.Tensor) -> bool:
    """TMA can read ``t``: a contiguous last axis, a 16-byte aligned base
    and positive strides in multiples of 16 bytes (an axis of one element
    is never stepped)."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or (st > 0 and (st * e) % 16 == 0)
                    for n, st in zip(t.shape[:-1], t.stride()[:-1])))


def _rows(t: torch.Tensor, name: str, tma: bool = False) -> torch.Tensor:
    """``t`` with a contiguous last axis (the kernel reads rows in place
    through the other strides) and, with ``tma``, as TMA can read it; a
    contiguous copy only when it is not."""
    if t.stride(-1) != 1 or (tma and not _tma_ok(t)):
        t = t.clone(memory_format=torch.contiguous_format)
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


def _prepare(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             q_offset: int, tma: bool = False) -> list[torch.Tensor]:
    """q, k, v checked for the kernels: one device, a head dim and group
    size they take, one dtype, rows contiguous (and TMA-readable with
    ``tma``)."""
    _check(q, k, v)
    d, kh = q.shape[3], k.shape[2]
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k and v must be on one device")
    if d not in HEAD_DIMS or q.shape[2] // kh > MAX_G:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS} and at most {MAX_G} query heads per "
                         f"KV head, got D={d}, G={q.shape[2] // kh}")
    if k.shape[1] == 0 or q_offset < 0:
        raise ValueError(f"flash_attention: needs Sk >= 1 and q_offset >= "
                         f"0, got Sk={k.shape[1]}, q_offset={q_offset}")
    q, k, v = _rows(q, "q", tma), _rows(k, "k", tma), _rows(v, "v", tma)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q, k and v must share a dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    return [q, k, v]


def _raise_on(err: int, entry: str) -> None:
    if err:
        msg = _library().flash_attention_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: int | None, q_offset: int,
            fma: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the forward kernel: (B, Sq, H, D) in q's dtype and the rows'
    log-sum-exp (B, H, Sq) in float32. bf16 runs on the tensor cores
    (:func:`_forward_design`); ``fma`` asks for the fp32 FMA design instead
    (the float32 path), to time the two side by side."""
    with span("repro.kernel.flash_attention"):
        design = _forward_design(q, fma)
        q, k, v = _prepare(q, k, v, q_offset, tma=design == "wgmma")
        b, sq, h, d = q.shape
        sk, kh = k.shape[1], k.shape[2]
        out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        if b * sq == 0:
            return out, lse
        lib = _library()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.flash_attention_launch(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), lse.data_ptr(), b, sq, sk, h, kh, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(d), int(causal),
                0 if window is None else int(window), int(q_offset),
                _vec(q, k, v), _DESIGNS[design], stream)
        _raise_on(err, "flash_attention_launch")
        _count(*(("launches", "wgmma_launches") if design == "wgmma"
                 else ("launches",)))
        return out, lse


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                causal: bool, window: int | None, q_offset: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the backward kernel: dq, dk, dv in the inputs' dtype."""
    with span("repro.kernel.flash_attention_bwd"):
        q, k, v = _prepare(q, k, v, q_offset)
        b, sq, h, d = q.shape
        sk, kh = k.shape[1], k.shape[2]
        if out.shape != q.shape or g.shape != q.shape or \
                lse.shape != (b, h, sq):
            raise ValueError(f"flash_attention backward: out "
                             f"{tuple(out.shape)}, g {tuple(g.shape)} and "
                             f"lse {tuple(lse.shape)} do not fit q "
                             f"{tuple(q.shape)}")
        out = out.to(q.dtype).contiguous()
        g = g.to(q.dtype).contiguous()
        lse = lse.float().contiguous()
        dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
        dk = torch.empty((b, sk, kh, d), dtype=q.dtype, device=q.device)
        dv = torch.empty_like(dk)
        if b * sq == 0:
            return dq, dk.zero_(), dv.zero_()
        delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        lib = _library()
        # the dK/dV pass's partial sums when it splits the query range
        win = 0 if window is None else int(window)
        n_ws = lib.flash_attention_bwd_workspace(_DTYPES[q.dtype], b, sk, kh,
                                                 d, int(causal), win)
        ws = torch.empty(max(n_ws, 0), dtype=torch.float32, device=q.device)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.flash_attention_bwd_launch(
                _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                ws.data_ptr() if n_ws > 0 else None, dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kh, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                1.0 / math.sqrt(d), int(causal), win, int(q_offset),
                _vec(q, k, v, out, g), stream)
        _raise_on(err, "flash_attention_bwd_launch")
        _count("bwd_launches")
        return dq, dk, dv


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None, q_offset: int = 0,
                            kv_chunk: int = 1024
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's two outputs, (B, Sq, H, D) and the rows'
    log-sum-exp (B, H, Sq) in float32: the kernel for a CUDA tensor, the
    plain versions at ``kv_chunk`` for a CPU tensor."""
    if q.device.type == "cpu":
        _check(q, k, v)
        kw = dict(causal=causal, window=window, q_offset=q_offset,
                  kv_chunk=kv_chunk)
        return (flash_attention_plain(q, k, v, **kw),
                flash_attention_lse_plain(q, k, **kw))
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, q_offset: int = 0,
                        kv_chunk: int = 1024
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv from the forward's ``out`` and ``lse`` and the output's
    gradient ``g``: the backward kernel for a CUDA tensor, its plain
    version at ``kv_chunk`` for a CPU tensor."""
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal,
                                         window=window, q_offset=q_offset,
                                         kv_chunk=kv_chunk)
    return _launch_bwd(q, k, v, out, lse, g, causal=causal, window=window,
                       q_offset=q_offset)


class FlashAttentionFn(torch.autograd.Function):
    """Forward: the forward kernel, keeping its output and log-sum-exp.
    Backward: the backward kernel, for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _launch(q, k, v, causal=causal, window=window,
                           q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _launch_bwd(q, k, v, out, lse, g, **ctx.args)
        return (*[gr if need else None
                  for gr, need in zip(grads, ctx.needs_input_grad[:3])],
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, kv_chunk: int = 1024,
                    score_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, K, D), H % K == 0 -> (B, Sq, H, D) in
    q's dtype. ``window``: keys with position > q_pos - window only;
    ``q_offset``: the absolute position of query 0 (keys sit at 0..Sk-1).

    A CUDA tensor launches the kernels through :class:`FlashAttentionFn`
    (float32 scores only); a CPU tensor takes :func:`flash_attention_plain`
    at ``kv_chunk`` and ``score_dtype``, and so does a ``meta`` tensor
    (shapes only: what the dry-run counts operations on)."""
    _check(q, k, v)
    if q.device.type in ("cpu", "meta"):   # meta: shapes only, no launch
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, kv_chunk=kv_chunk,
                                     score_dtype=score_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if score_dtype != torch.float32:
        raise ValueError(f"flash_attention: the kernel computes float32 "
                         f"scores, got score_dtype {score_dtype}")
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)


flash_attention.launches = 0
flash_attention.wgmma_launches = 0   # of which the Hopper design
flash_attention.bwd_launches = 0
