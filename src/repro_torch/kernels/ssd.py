"""The Mamba-2 SSD chunked scan: the CUDA kernels for Hopper (forward and
backward), their plain PyTorch versions, and the autograd function that
trains through them.

Port of ``repro/kernels/ssd.py`` (the Pallas kernel ``ssd_scan``) widened
to what the model's ``ssd_chunked`` (``repro/models/ssd.py``) computes
around it: an optional initial state ``h0``, the final state, and any
sequence length (the ragged last chunk is masked in the kernels, which is
exactly the reference's zero padding: padded steps have dt = 0, so they
neither decay nor feed the state). The kernels are ``csrc/ssd.cu``, built
by :mod:`repro_torch.kernels.build` and called through ``ctypes``; the note
at the top of the source says what bounds them and how they are laid out.

:func:`ssd_scan` dispatches on the tensor's device: a CUDA tensor runs
:class:`SSDScanFn`, whose forward launches the forward kernels (counted in
``ssd_scan.launches``) and whose backward launches the backward kernels
(counted in ``ssd_scan.bwd_launches``); each raises if its kernels cannot
run. The JAX package has no backward kernel: its training differentiates
the XLA ``ssd_chunked``. A CPU tensor takes :func:`ssd_scan_plain`
directly and trains by autograd through it. :func:`ssd_scan_bwd_plain` is
the backward's formula in plain PyTorch, for the tests and for holding the
kernel to it on the card; no training path calls it.

**Masked exponent.** The reference forms ``exp(cum_i - cum_j)`` over the
whole (chunk, chunk) square and masks the product afterwards. Above the
diagonal the exponent is large and positive, so ``exp`` overflows to inf;
the forward ``where`` hides it, but the backward multiplies a zero
cotangent by inf and the gradient is NaN (at mamba2-130m's width, most of
its gradient leaves). Here the exponent is masked *before* ``exp``, in the
plain versions and in the kernels, so no value above the diagonal is ever
formed. Forward values equal the reference's; gradients equal the
reference's wherever those are finite.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.obs.trace import span

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
        lib.ssd_workspace_floats.argtypes = [i32] * 7
        lib.ssd_workspace_floats.restype = i64
        lib.ssd_scan_launch.argtypes = (
            [i32] + [ptr] * 9 + [i32] * 5 + [i64] * 10 + [i32, ptr])
        lib.ssd_scan_launch.restype = i32
        lib.ssd_scan_bwd_launch.argtypes = (
            [i32] + [ptr] * 15 + [i32] * 5 + [i64] * 13 + [i32, ptr])
        lib.ssd_scan_bwd_launch.restype = i32
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


def ssd_scan_bwd_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       bmat: torch.Tensor, cmat: torch.Tensor,
                       gy: torch.Tensor | None, g_hfin: torch.Tensor | None,
                       *, chunk: int = 256, h0: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: the gradient of
    :func:`ssd_scan_plain`'s (y, final state) for the cotangents ``gy``
    (like y) and ``g_hfin`` (like the final state); either may be None
    (zero). By the explicit formulas, all chunks at once but for the
    (B, H, P, N) state, which is carried forward over chunks, and its
    adjoint, carried backward:

    * the state at each chunk's start ``hs`` as in the forward, and the
      adjoint at each chunk's end ``dn``: that of the last chunk is
      ``g_hfin``, and D(start) = exp(cum_L) D(end) + sum_i exp(cum_i) gy_i
      C_i^T; dh0 is D at the start of chunk 0;
    * within a chunk, with dM_ij = gy_i . x_j, E_ij = exp(cum_i - cum_j)
      for j <= i (0 above the diagonal, never formed), M_ij = (C_i . B_j)
      E_ij dt_j and dCB_ij = dM_ij E_ij dt_j: dx_j = sum_i M_ij gy_i +
      coef_j dn B_j, dB_j = sum_i dCB_ij C_i + coef_j dn^T x_j, dC_i =
      sum_j dCB_ij B_j + exp(cum_i) hs^T gy_i (dB and dC summed over heads),
      with coef_j = exp(cum_L - cum_j) dt_j;
    * dt directly (its factor in M and coef) and through cum: dcum_i gets
      the row sums of S = dM o M less its column sums, the inter-chunk
      term gy_i . exp(cum_i) hs C_i, less coef_i x_i . dn B_i, and the last
      row also exp(cum_L) <dn, hs> + sum_j coef_j x_j . dn B_j; dla_j is
      dcum summed from the chunk's end, ddt_j += a dla_j and da = sum dt
      dla.

    Returns (dx in x's dtype, ddt and da in float32, dB and dC in B's
    dtype, dh0 (B, H, P, N) float32); float64 inputs stay float64."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    f32 = torch.promote_types(x.dtype, torch.float32)   # float64 stays
    dev = x.device
    dh0 = (torch.zeros((b, h, p, n), dtype=f32, device=dev)
           if g_hfin is None else g_hfin.to(f32))
    if s == 0:
        return (torch.zeros_like(x), torch.zeros(dt.shape, dtype=f32,
                                                 device=dev),
                torch.zeros((h,), dtype=f32, device=dev),
                torch.zeros_like(bmat), torch.zeros_like(cmat), dh0)
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s

    def padded(t, dims):
        t = t.to(f32)
        return torch.nn.functional.pad(t, (0, 0) * dims + (0, pad)) \
            if pad else t
    xc = padded(x, 2).reshape(b, nc, c, h, p)
    gc = (torch.zeros_like(xc) if gy is None else
          padded(gy, 2).reshape(b, nc, c, h, p))
    dtc = padded(dt, 1).reshape(b, nc, c, h)
    bc = padded(bmat, 1).reshape(b, nc, c, n)
    cc = padded(cmat, 1).reshape(b, nc, c, n)
    af = a.to(f32)
    cum = torch.cumsum(dtc * af, dim=2)                       # (B,Z,c,H)
    last = cum[:, :, -1]                                      # (B,Z,H)
    decay = torch.exp(last)
    ex = torch.exp(cum)
    coef = torch.exp(last[:, :, None] - cum) * dtc            # (B,Z,c,H)
    # the state at each chunk's start, and the adjoint at each chunk's end
    upd = torch.einsum("bzch,bzcn,bzchp->bzhpn", coef, bc, xc)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=dev)
             if h0 is None else h0.to(f32))
    starts = []
    for z in range(nc):
        starts.append(state)
        state = decay[:, z, :, None, None] * state + upd[:, z]
    hs = torch.stack(starts, dim=1)                           # (B,Z,H,P,N)
    adj_upd = torch.einsum("bzch,bzchp,bzcn->bzhpn", ex, gc, cc)
    ends = [None] * nc
    for z in reversed(range(nc)):
        ends[z] = dh0
        dh0 = decay[:, z, :, None, None] * dh0 + adj_upd[:, z]
    dn = torch.stack(ends, dim=1)                             # (B,Z,H,P,N)
    # within a chunk; the exponent is masked before exp
    mask = torch.ones(c, c, dtype=torch.bool, device=dev).tril()
    dec = torch.where(mask[:, :, None], cum[:, :, :, None, :] -
                      cum[:, :, None, :, :],
                      torch.full((), float("-inf"), dtype=f32, device=dev))
    e = torch.exp(dec)                                        # (B,Z,i,j,H)
    cbe = torch.einsum("bzin,bzjn->bzij", cc, bc)[..., None] * e
    dt_j = dtc[:, :, None, :, :]
    m = cbe * dt_j
    dm = torch.einsum("bzihp,bzjhp->bzijh", gc, xc)
    dcb = dm * e * dt_j
    # S = dM o M moves cum_i up and cum_j down by the same amount; its
    # diagonal cancels exactly and is left out of both sums
    sv = dm * cbe
    diag = torch.diagonal(sv, dim1=2, dim2=3).transpose(2, 3)  # (B,Z,j,H)
    sv = sv * (~torch.eye(c, dtype=torch.bool, device=dev))[:, :, None]
    q = sv.sum(2)                                             # (B,Z,j,H)
    r = (sv * dt_j).sum(3)                                    # (B,Z,i,H)
    bd = torch.einsum("bzjn,bzhpn->bzjhp", bc, dn)            # dn B_j
    dx = torch.einsum("bzijh,bzihp->bzjhp", m, gc) + coef[..., None] * bd
    v = (xc * bd).sum(-1)                                     # x_j . dn B_j
    t = coef * v
    gh = torch.einsum("bzihp,bzhpn->bzihn", gc, hs)           # hs^T gy_i
    db = (torch.einsum("bzijh,bzin->bzjn", dcb, cc)
          + torch.einsum("bzjh,bzjhp,bzhpn->bzjn", coef, xc, dn))
    dc = (torch.einsum("bzijh,bzjn->bzin", dcb, bc)
          + torch.einsum("bzih,bzihn->bzin", ex, gh))
    inter = ex * (cc[:, :, :, None, :] * gh).sum(-1)          # (B,Z,i,H)
    # dla_j = sum_{k>=j} dcum_k; the state term -t_k of dcum_k and its sum
    # on the last row cancel for k >= j, so t enters as its sum over k < j
    dla = (torch.flip(torch.cumsum(torch.flip(r - dtc * q + inter, (2,)), 2),
                      (2,))
           + (decay * (dn * hs).sum((-1, -2)))[:, :, None]
           + torch.nn.functional.pad(torch.cumsum(t, 2)[:, :, :-1],
                                     (0, 0, 1, 0)))
    ddt = q + diag + torch.exp(last[:, :, None] - cum) * v + af * dla
    da = (dtc * dla).sum((0, 1, 2))
    return (dx.reshape(b, nc * c, h, p)[:, :s].to(x.dtype),
            ddt.reshape(b, nc * c, h)[:, :s],
            da,
            db.reshape(b, nc * c, n)[:, :s].to(bmat.dtype),
            dc.reshape(b, nc * c, n)[:, :s].to(cmat.dtype),
            dh0)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def _count(name: str) -> None:
    with _count_lock:
        setattr(ssd_scan, name, getattr(ssd_scan, name) + 1)


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` with a contiguous last axis (the kernels read rows in place
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


def _prepare(x, dt, a, bmat, cmat, h0):
    """The inputs checked for the kernels: one device, widths they take,
    one dtype for x, B and C, rows contiguous; dt, a and h0 float32."""
    dev = x.device
    if not all(t.device == dev for t in (dt, a, bmat, cmat)) or (
            h0 is not None and h0.device != dev):
        raise ValueError("ssd_scan: all inputs must be on one device")
    p, n = x.shape[3], bmat.shape[-1]
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan: the kernel takes head_dim <= {MAX_P} "
                         f"and d_state <= {MAX_N}, got P={p}, N={n}")
    x = _rows(x, "x")
    bmat, cmat = _rows(bmat, "B"), _rows(cmat, "C")
    if not (bmat.dtype == cmat.dtype == x.dtype):
        raise TypeError(f"ssd_scan: x, B and C must share a dtype, got "
                        f"{x.dtype}, {bmat.dtype}, {cmat.dtype}")
    dt = dt.to(torch.float32)
    a = a.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    return x, dt, a, bmat, cmat, h0


def _raise_on(err: int, entry: str) -> None:
    if err:
        msg = _library().ssd_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")


def _workspace(x, n: int, backward: int) -> torch.Tensor:
    b, s, h, p = x.shape
    count = _library().ssd_workspace_floats(_DTYPES[x.dtype], b, s, h, p, n,
                                            backward)
    return torch.empty(count, dtype=torch.float32, device=x.device)


def _launch(x, dt, a, bmat, cmat, h0):
    """Run the forward kernels: (y like x, final state (B, H, P, N)
    float32)."""
    with span("repro.kernel.ssd_scan"):
        x, dt, a, bmat, cmat, h0 = _prepare(x, dt, a, bmat, cmat, h0)
        b, s, h, p = x.shape
        n = bmat.shape[-1]
        y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
        h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
        if b * h == 0:
            return y, h_fin
        ws = _workspace(x, n, 0)
        lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.ssd_scan_launch(
                _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                bmat.data_ptr(), cmat.data_ptr(),
                0 if h0 is None else h0.data_ptr(), y.data_ptr(),
                h_fin.data_ptr(), ws.data_ptr(), b, s, h, p, n,
                *x.stride()[:3], *bmat.stride()[:2], *cmat.stride()[:2],
                *dt.stride(), _vec(x, bmat, cmat), stream)
        _raise_on(err, "ssd_scan_launch")
        _count("launches")
        return y, h_fin


def _launch_bwd(x, dt, a, bmat, cmat, h0, gy, g_hfin):
    """Run the backward kernels for the cotangents ``gy`` and ``g_hfin``
    (either may be None: zero): (dx like x, ddt and da float32, dB and dC
    like B, dh0 float32 or None when there is no h0)."""
    with span("repro.kernel.ssd_scan_bwd"):
        x, dt, a, bmat, cmat, h0 = _prepare(x, dt, a, bmat, cmat, h0)
        b, s, h, p = x.shape
        n = bmat.shape[-1]
        dev = x.device
        gy = torch.zeros_like(x) if gy is None else _rows(gy.to(x.dtype), "gy")
        if g_hfin is not None:
            g_hfin = g_hfin.to(torch.float32).contiguous()
        dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
        ddt = torch.empty((b, s, h), dtype=torch.float32, device=dev)
        da = torch.zeros((h,), dtype=torch.float32, device=dev)
        db = torch.empty((b, s, n), dtype=x.dtype, device=dev)
        dc = torch.empty_like(db)
        dh0 = (None if h0 is None else
               torch.empty((b, h, p, n), dtype=torch.float32, device=dev))
        if b * h == 0:
            return dx, ddt, da, db, dc, dh0
        ws = _workspace(x, n, 1)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.ssd_scan_bwd_launch(
                _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                bmat.data_ptr(), cmat.data_ptr(),
                0 if h0 is None else h0.data_ptr(), gy.data_ptr(),
                0 if g_hfin is None else g_hfin.data_ptr(), dx.data_ptr(),
                ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                0 if dh0 is None else dh0.data_ptr(), ws.data_ptr(),
                b, s, h, p, n, *x.stride()[:3], *bmat.stride()[:2],
                *cmat.stride()[:2], *dt.stride(), *gy.stride()[:3],
                _vec(x, bmat, cmat, gy), stream)
        _raise_on(err, "ssd_scan_bwd_launch")
        _count("bwd_launches")
        return dx, ddt, da, db, dc, dh0


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bmat: torch.Tensor, cmat: torch.Tensor,
                 gy: torch.Tensor | None, g_hfin: torch.Tensor | None, *,
                 h0: torch.Tensor | None = None) -> tuple[torch.Tensor, ...]:
    """The backward kernel on CUDA tensors (what :class:`SSDScanFn`'s
    backward runs): the gradient of ``ssd_scan``'s (y, final state) for the
    cotangents ``gy`` and ``g_hfin``, as :func:`ssd_scan_bwd_plain` returns
    it, except that dh0 is None when ``h0`` is. Raises if the kernels
    cannot run."""
    _check(x, dt, a, bmat, cmat, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cuda, not {x.device}")
    return _launch_bwd(x, dt, a, bmat, cmat, h0, gy, g_hfin)


class SSDScanFn(torch.autograd.Function):
    """Forward: the forward kernels. Backward: the backward kernels, for x,
    dt, a, B, C and h0; the chunk states are recomputed there, not saved."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, h0):
        y, h_fin = _launch(x, dt, a, bmat, cmat, h0)
        ctx.save_for_backward(x, dt, a, bmat, cmat, h0)
        ctx.set_materialize_grads(False)   # an unused output gets None
        return y, h_fin

    @staticmethod
    def backward(ctx, gy, gh):
        x, dt, a, bmat, cmat, h0 = ctx.saved_tensors
        needs = ctx.needs_input_grad[:6]
        if gy is None and gh is None:
            return (None,) * 6
        grads = _launch_bwd(x, dt, a, bmat, cmat, h0, gy, gh)
        like = (x, dt, a, bmat, cmat, h0)
        return tuple(g.to(t.dtype) if need and g is not None else None
                     for g, t, need in zip(grads, like, needs))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int = 256,
             h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, H, P); dt: (B, S, H) post-softplus; a: (H,) negative;
    bmat/cmat: (B, S, N) in x's dtype; h0: (B, H, P, N) float32 or None.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32).
    Any S: the ragged last chunk is masked, not padded.

    A CUDA tensor launches the kernels through :class:`SSDScanFn` (their own
    chunk is 64 steps, which the outputs and gradients do not depend on
    beyond rounding); a CPU tensor takes :func:`ssd_scan_plain` at
    ``chunk``, and so does a ``meta`` tensor (shapes only: what the dry-run
    counts operations on)."""
    _check(x, dt, a, bmat, cmat, h0)
    if x.device.type in ("cpu", "meta"):   # meta: shapes only, no launch
        return ssd_scan_plain(x, dt, a, bmat, cmat, chunk=chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")
    return SSDScanFn.apply(x, dt, a, bmat, cmat, h0)


ssd_scan.launches = 0
ssd_scan.bwd_launches = 0
