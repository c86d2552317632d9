"""The Mamba-2 SSD chunked scan: the CUDA kernel for Hopper, its plain
PyTorch version, and the autograd function that trains through it.

Port of ``repro/kernels/ssd.py`` (the Pallas kernel ``ssd_scan``) widened
to what the model's ``ssd_chunked`` (``repro/models/ssd.py``) computes
around it: an optional initial state ``h0``, the final state, and any
sequence length (the ragged last chunk is masked in the kernel, which is
exactly the reference's zero padding: padded steps have dt = 0, so they
neither decay nor feed the state). The kernel is ``csrc/ssd.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``; the note at
the top of the source says what bounds it and how it is laid out.

:func:`ssd_scan` dispatches on the tensor's device: a CUDA tensor runs
:class:`SSDScanFn`, whose forward launches the kernel (counted in
``ssd_scan.launches``) or raises, and whose backward recomputes
:func:`ssd_scan_plain` with differentiable PyTorch ops and takes its
gradients. The JAX package has no backward kernel either: its training
differentiates the XLA ``ssd_chunked``. A CPU tensor takes
:func:`ssd_scan_plain` directly.

**Masked exponent.** The reference forms ``exp(cum_i - cum_j)`` over the
whole (chunk, chunk) square and masks the product afterwards. Above the
diagonal the exponent is large and positive, so ``exp`` overflows to inf;
the forward ``where`` hides it, but the backward multiplies a zero
cotangent by inf and the gradient is NaN (at mamba2-130m's width, most of
its gradient leaves). Here the exponent is masked *before* ``exp``, in the
plain version and in the kernel, so no value above the diagonal is ever
formed. Forward values equal the reference's; gradients equal the
reference's wherever those are finite.
"""
from __future__ import annotations

import ctypes
import threading

import torch

MAX_P, MAX_N = 64, 128      # head_dim and d_state the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_count_lock = threading.Lock()
_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's shared library, built and typed at first use."""
    global _lib
    if _lib is None:
        from .build import load
        lib = load("ssd")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_scan_launch.argtypes = (
            [i32] + [ptr] * 8 + [i32] * 5 + [i64] * 12 + [i32, ptr])
        lib.ssd_scan_launch.restype = i32
        lib.ssd_error_string.argtypes = [i32]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bmat: torch.Tensor, cmat: torch.Tensor, *,
                   chunk: int = 256, h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`ssd_scan`: the reference's ``ssd_chunked``
    with the masked exponent. The intra-chunk products and each chunk's
    state contribution are taken for all chunks at once; only the (B, H, P,
    N) state is carried from chunk to chunk in a loop. Differentiable.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative;
    bmat/cmat: (B, S, N); h0: (B, H, P, N) float32 or None. Returns
    (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32). The
    sums are float32 (float64 for float64 inputs)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if s == 0:
        state = (torch.zeros((b, h, p, n), dtype=torch.float32,
                             device=x.device) if h0 is None else
                 h0.to(torch.float32))
        return x.clone(), state
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    f32 = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    xf, dtf = x.to(f32), dt.to(f32)
    bf, cf = bmat.to(f32), cmat.to(f32)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
        bf = torch.nn.functional.pad(bf, (0, 0, 0, pad))
        cf = torch.nn.functional.pad(cf, (0, 0, 0, pad))
    xc = xf.reshape(b, nc, c, h, p)
    dtc = dtf.reshape(b, nc, c, h)
    bc = bf.reshape(b, nc, c, n)
    cc = cf.reshape(b, nc, c, n)
    cum = torch.cumsum(dtc * a.to(f32), dim=2)                # (B,Z,c,H)
    # intra-chunk: M_ij = (C_i.B_j) exp(cum_i - cum_j) dt_j for i >= j; the
    # exponent is masked before exp, so nothing above the diagonal overflows
    cb = torch.einsum("bzin,bzjn->bzij", cc, bc)              # (B,Z,c,c)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,Z,i,j,H)
    mask = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    dec = torch.where(mask[:, :, None], dec,
                      torch.full((), float("-inf"), device=x.device))
    m = torch.exp(dec) * cb[..., None] * dtc[:, :, None, :, :]
    y = torch.einsum("bzijh,bzjhp->bzihp", m, xc)
    # each chunk's contribution to the state it hands on
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc           # (B,Z,c,H)
    upd = torch.einsum("bzch,bzcn,bzchp->bzhpn", tail, bc, xc)
    decay = torch.exp(cum[:, :, -1])                          # (B,Z,H)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    starts = []
    for z in range(nc):
        starts.append(state)
        state = decay[:, z, :, None, None] * state + upd[:, z]
    # inter-chunk: y_i += exp(cum_i) C_i . h(chunk start)
    hs = torch.stack(starts, dim=1)                           # (B,Z,H,P,N)
    y = y + torch.einsum("bzin,bzhpn->bzihp", cc, hs) * \
        torch.exp(cum)[..., None]
    y = y.reshape(b, nc * c, h, p)[:, :s]
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _count() -> None:
    with _count_lock:
        ssd_scan.launches += 1


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` with a contiguous last axis (the kernel reads rows in place
    through the other strides); a copy only when the last axis is
    strided."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    if t.dtype not in _DTYPES:
        raise TypeError(f"ssd_scan: {name} must be float32 or bfloat16, got "
                        f"{t.dtype}")
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


def _check(x, dt, a, bmat, cmat, h0) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    b, s, h, _ = x.shape
    n = bmat.shape[-1]
    if dt.shape != (b, s, h) or a.shape != (h,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} and a "
                         f"{tuple(a.shape)} do not fit x {tuple(x.shape)}")
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(f"ssd_scan: B {tuple(bmat.shape)} and C "
                         f"{tuple(cmat.shape)} must be (B, S, N)")
    if h0 is not None and h0.shape != (b, h, x.shape[3], n):
        raise ValueError(f"ssd_scan: h0 {tuple(h0.shape)} must be "
                         f"(B, H, P, N)")


def _launch(x, dt, a, bmat, cmat, h0):
    """Run the kernel: (y like x, final state (B, H, P, N) float32)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    dev = x.device
    if not all(t.device == dev for t in (dt, a, bmat, cmat)) or (
            h0 is not None and h0.device != dev):
        raise ValueError("ssd_scan: all inputs must be on one device")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan: the kernel takes head_dim <= {MAX_P} "
                         f"and d_state <= {MAX_N}, got P={p}, N={n}")
    x = _rows(x, "x")
    bmat, cmat = _rows(bmat, "B"), _rows(cmat, "C")
    if not (bmat.dtype == cmat.dtype == x.dtype):
        raise TypeError(f"ssd_scan: x, B and C must share a dtype, got "
                        f"{x.dtype}, {bmat.dtype}, {cmat.dtype}")
    dt = dt.to(torch.float32).contiguous()
    a = a.to(torch.float32).contiguous()
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if b * h == 0:
        return y, h_fin
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_launch(
            _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(),
            0 if h0 is None else h0.data_ptr(), y.data_ptr(),
            h_fin.data_ptr(), b, s, h, p, n, *x.stride()[:3],
            *bmat.stride()[:2], *cmat.stride()[:2], *dt.stride(),
            *y.stride()[:2], _vec(x, bmat, cmat), stream)
    if err:
        raise RuntimeError(f"ssd_scan_launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    _count()
    return y, h_fin


class SSDScanFn(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: the plain version recomputed with
    differentiable ops (masked exponent) at ``chunk``, and its gradients
    for x, dt, a, B, C and h0."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, h0, chunk):
        y, h_fin = _launch(x, dt, a, bmat, cmat, h0)
        ctx.save_for_backward(x, dt, a, bmat, cmat, h0)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused output gets None
        return y, h_fin

    @staticmethod
    def backward(ctx, gy, gh):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip(saved, needs)]
            y, h_fin = ssd_scan_plain(*ins[:5], chunk=ctx.chunk, h0=ins[5])
            pairs = [(o, g) for o, g in ((y, gy), (h_fin, gh)) if g is not None]
            wrt = [t for t, need in zip(ins, needs) if need and t is not None]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True)
                       if wrt and pairs else [None] * len(wrt))
        out = [next(got) if need and t is not None else None
               for t, need in zip(ins, needs)]
        return (*out, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 256,
             h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative;
    bmat/cmat: (B, S, N) in x's dtype; h0: (B, H, P, N) float32 or None.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).
    Any S: the ragged last chunk is masked, not padded.

    A CUDA tensor launches the kernel through :class:`SSDScanFn` (its own
    chunk is 32 steps, which the output does not depend on beyond rounding;
    ``chunk`` is the chunk of the backward's recomputation); a CPU tensor
    takes :func:`ssd_scan_plain` at ``chunk``."""
    _check(x, dt, a, bmat, cmat, h0)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    return SSDScanFn.apply(x, dt, a, bmat, cmat, h0, chunk)


ssd_scan.launches = 0
