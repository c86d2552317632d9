"""Flash-decode inputs shared by the port's CPU tests, its card tests and
``chip_smoke.py``: the cases of ``tests/test_serve.py`` (causal and ragged
for GQA groups 1, 2 and 4, window, ring positions, padded and empty lanes,
paged), one with Dv != Dk, the edges of the kernels' split of the key range
over blocks (a long sparse cache, a window whose ends fall inside splits,
live pages separated by unbound ones, slots with no valid key), groups of
10 and 16 query heads on one KV head of 256 dims (recurrentgemma-2b's, and
the kernels' largest: two head groups a KV head), 7 query heads on each of
two KV heads of 64 dims (internvl2-1b's: one head group with a lane
idle), and the serving main paths' shapes. All from numpy seeds; imports neither jax nor
the port, so the card tests and the smoke script run where jax is absent.

A case is a dict: ``kind`` ("dense" | "paged"), float32 arrays ``q``
(B, 1, H, Dk) and ``k``/``v`` (dense (B, S, K, D), paged (P, page_size,
K, D)), int32 ``qpos`` (B,) and ``kpos`` (B, S) or ``table`` (B, pages),
and ``window``, ``block_k``, ``bounded`` and ``empty`` (lanes that must
come out exactly zero).
"""
import numpy as np

ATOL_F32 = 2e-5    # tests/test_serve.py
ATOL_BF16 = 2e-2   # tests/test_kernels.py, bf16


def _rand_qkv(rng, b, s, h, kh, dk, dv=None):
    dv = dk if dv is None else dv
    return (rng.standard_normal((b, 1, h, dk)).astype(np.float32),
            rng.standard_normal((b, s, kh, dk)).astype(np.float32),
            rng.standard_normal((b, s, kh, dv)).astype(np.float32))


def dense_kpos(qpos, s):
    """Contiguous-cache positions: row index = position, -1 past the end."""
    pos = np.tile(np.arange(s, dtype=np.int32), (len(qpos), 1))
    return np.where(pos <= np.asarray(qpos)[:, None], pos, -1).astype(np.int32)


def ring_kpos(t, window):
    """Ring layout after ``t[b]`` tokens: row j holds position
    t-1-((t-1-j) mod window); negatives are rows not yet written."""
    j = np.arange(window)
    return np.stack([ti - 1 - ((ti - 1 - j) % window)
                     for ti in t]).astype(np.int32)


def _dense(q, k, v, qpos, kpos, window=None, block_k=128, bounded=True,
           empty=()):
    return dict(kind="dense", q=q, k=k, v=v,
                qpos=np.asarray(qpos, np.int32), kpos=kpos, window=window,
                block_k=block_k, bounded=bounded, empty=tuple(empty))


def bind_pages(qpos, page_size, pages_per_slot, n_pages, rng=None):
    """A table binding each slot's logical pages up to its position to
    distinct physical pages > 0 (page 0 is the trash page), -1 beyond."""
    table = np.full((len(qpos), pages_per_slot), -1, np.int32)
    free = list(range(1, n_pages))
    if rng is not None:
        rng.shuffle(free)
    for bi, p in enumerate(qpos):
        for li in range(int(p) // page_size + 1):
            table[bi, li] = free.pop()
    return table


def _causal(kh):
    rng = np.random.default_rng(0)
    q, k, v = _rand_qkv(rng, b=3, s=96, h=4, kh=kh, dk=16)
    qpos = [5, 40, 95]
    return _dense(q, k, v, qpos, dense_kpos(qpos, 96), block_k=32)


def _window():
    rng = np.random.default_rng(1)
    q, k, v = _rand_qkv(rng, b=2, s=64, h=4, kh=2, dk=8)
    qpos = [20, 63]
    return _dense(q, k, v, qpos, dense_kpos(qpos, 64), window=16, block_k=16)


def _ring():
    rng = np.random.default_rng(2)
    s = 32
    q, k, v = _rand_qkv(rng, b=2, s=s, h=2, kh=2, dk=8)
    t = np.asarray([45, 7])
    return _dense(q, k, v, t - 1, ring_kpos(t, s), window=s, block_k=16,
                  bounded=False)


def _padded_empty():
    rng = np.random.default_rng(3)
    q, k, v = _rand_qkv(rng, b=3, s=32, h=2, kh=1, dk=8)
    qpos = [10, 0, 0]
    kpos = dense_kpos(qpos, 32)
    kpos[1:] = -1  # lanes 1, 2 inactive: nothing valid
    return _dense(q, k, v, qpos, kpos, block_k=16, empty=(1, 2))


def _dv_differs():
    rng = np.random.default_rng(6)
    q, k, v = _rand_qkv(rng, b=2, s=40, h=4, kh=2, dk=16, dv=8)
    qpos = [17, 39]
    return _dense(q, k, v, qpos, dense_kpos(qpos, 40), block_k=16)


def _paged():
    rng = np.random.default_rng(4)
    b, kh, h, dk, ps, pps, npg = 3, 2, 4, 8, 8, 4, 16
    pool_k = rng.standard_normal((npg, ps, kh, dk)).astype(np.float32)
    pool_v = rng.standard_normal((npg, ps, kh, dk)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, dk)).astype(np.float32)
    qpos = np.asarray([5, 20, 30], np.int32)
    # the reference test pops physical pages from the end of the free list
    table = bind_pages(qpos, ps, pps, npg)
    return dict(kind="paged", q=q, k=pool_k, v=pool_v, qpos=qpos,
                table=table, window=None, empty=())


def _paged_window_unbound():
    """A window over pages, an unbound page inside the window, and a lane
    whose table row is all unbound (it must come out exactly zero)."""
    rng = np.random.default_rng(5)
    b, kh, h, dk, ps, pps, npg = 3, 1, 2, 16, 4, 8, 20
    pool_k = rng.standard_normal((npg, ps, kh, dk)).astype(np.float32)
    pool_v = rng.standard_normal((npg, ps, kh, dk)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, dk)).astype(np.float32)
    qpos = np.asarray([13, 27, 9], np.int32)
    table = bind_pages(qpos, ps, pps, npg, np.random.RandomState(0))
    table[1, 5] = -1
    table[2] = -1
    return dict(kind="paged", q=q, k=pool_k, v=pool_v, qpos=qpos,
                table=table, window=10, empty=(2,))


def _long_sparse():
    """S = 4096 rows: slots at positions 0, 1, 63, 64 and S - 1, a third of
    each prefix's rows invalid, so whole tiles and splits hold no key."""
    rng = np.random.default_rng(7)
    s = 4096
    q, k, v = _rand_qkv(rng, b=5, s=s, h=2, kh=1, dk=8)
    qpos = [0, 1, 63, 64, s - 1]
    kpos = dense_kpos(qpos, s)
    kpos[rng.random(kpos.shape) < 1 / 3] = -1
    kpos[3, :64] = -1            # slot 3 keeps only position 64
    kpos[3, 64] = 64
    kpos[4, 100:4000] = -1       # slot 4: two far-apart runs
    kpos[0, 0] = 0               # slots 0 and 1 keep position 0
    kpos[1, 0] = 0
    return _dense(q, k, v, qpos, kpos, block_k=128)


def _window_inside_splits():
    """A window whose first and last keys fall inside 32-row tiles (and so
    inside splits), on a dense and bounded cache."""
    rng = np.random.default_rng(8)
    q, k, v = _rand_qkv(rng, b=3, s=256, h=4, kh=2, dk=16)
    qpos = [100, 150, 237]
    return _dense(q, k, v, qpos, dense_kpos(qpos, 256), window=45,
                  block_k=32)


def _paged_gaps():
    """Live pages separated by unbound ones, a window across them, and pages
    past the slot's position bound (never read)."""
    rng = np.random.default_rng(9)
    b, kh, h, dk, ps, pps, npg = 3, 2, 4, 8, 8, 12, 40
    pool_k = rng.standard_normal((npg, ps, kh, dk)).astype(np.float32)
    pool_v = rng.standard_normal((npg, ps, kh, dk)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, dk)).astype(np.float32)
    qpos = np.asarray([60, 90, 45], np.int32)
    table = bind_pages(qpos, ps, pps, npg, np.random.RandomState(2))
    table[0, [1, 3, 4, 6]] = -1
    table[1, [0, 2, 5, 6, 7, 9]] = -1
    table[2, 1:5] = -1
    table[2, 6:] = 39            # bound past the position: masked
    return dict(kind="paged", q=q, k=pool_k, v=pool_v, qpos=qpos,
                table=table, window=30, empty=())


def _no_valid_key():
    """Slots with no valid key at all, of three kinds, on a ring
    (unbounded) cache: every row -1, a position of -1, and keys that all
    lie past the query's position."""
    rng = np.random.default_rng(10)
    s = 96
    q, k, v = _rand_qkv(rng, b=3, s=s, h=4, kh=1, dk=8)
    qpos = [50, -1, 20]
    kpos = np.tile(np.arange(s, dtype=np.int32), (3, 1))
    kpos[0] = -1
    kpos[2] += 21
    return _dense(q, k, v, qpos, kpos, block_k=32, bounded=False,
                  empty=(0, 1, 2))


def _wide_group(g, kind, kh=1, d=256):
    """G query heads on each of ``kh`` KV heads of ``d`` dims:
    recurrentgemma-2b's group (G = 10) or MAX_G (16) on one KV head of 256,
    which the kernels cut into two head groups, or internvl2-1b's (G = 7 on
    two KV heads of 64), one head group with a lane idle. ``kind``: a dense
    bounded cache with ragged positions, a ring that has wrapped (window
    64) or a paged cache."""
    rng = np.random.default_rng(20 + g if (kh, d) == (1, 256)
                                else 40 + g)
    b, h = 3, g * kh
    if kind == "paged":
        ps, pps, npg = 16, 6, 20
        pool_k = rng.standard_normal((npg, ps, kh, d)).astype(np.float32)
        pool_v = rng.standard_normal((npg, ps, kh, d)).astype(np.float32)
        q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
        qpos = np.asarray([7, 50, 95], np.int32)
        table = bind_pages(qpos, ps, pps, npg, np.random.RandomState(g))
        return dict(kind="paged", q=q, k=pool_k, v=pool_v, qpos=qpos,
                    table=table, window=None, empty=())
    if kind == "ring":
        q, k, v = _rand_qkv(rng, b, 64, h, kh, d)
        t = np.asarray([100, 9, 64])
        return _dense(q, k, v, t - 1, ring_kpos(t, 64), window=64,
                      block_k=32, bounded=False)
    q, k, v = _rand_qkv(rng, b, 96, h, kh, d)
    qpos = [3, 47, 95]
    return _dense(q, k, v, qpos, dense_kpos(qpos, 96), block_k=32)


CASES = {
    **{f"causal_ragged_kh{kh}": (lambda kh=kh: _causal(kh))
       for kh in (4, 2, 1)},
    "window": _window,
    "ring_positions": _ring,
    "padded_and_empty": _padded_empty,
    "dv_differs": _dv_differs,
    "paged": _paged,
    "paged_window_unbound": _paged_window_unbound,
    "long_sparse": _long_sparse,
    "window_inside_splits": _window_inside_splits,
    "paged_gaps": _paged_gaps,
    "no_valid_key": _no_valid_key,
    **{f"group{g}_{kind}": (lambda g=g, kind=kind: _wide_group(g, kind))
       for g in (10, 16) for kind in ("dense", "ring", "paged")},
    **{f"group7_kh2_d64_{kind}": (lambda kind=kind: _wide_group(7, kind, 2,
                                                                 64))
       for kind in ("dense", "ring", "paged")},
}


def logical_view(case):
    """A paged case's gathered logical K/V (B, pages*page_size, K, D) and
    key positions (-1 where the page is unbound)."""
    table = case["table"]
    b, pps = table.shape
    ps = case["k"].shape[1]
    phys = np.maximum(table, 0)
    gk = case["k"][phys].reshape(b, pps * ps, *case["k"].shape[2:])
    gv = case["v"][phys].reshape(b, pps * ps, *case["v"].shape[2:])
    lpos = np.tile(np.arange(pps * ps, dtype=np.int32), (b, 1))
    lpos = np.where(table[:, lpos[0] // ps] >= 0, lpos, -1).astype(np.int32)
    return gk, gv, lpos


def oracle(case):
    """Naive per-(slot, head) softmax attention over the valid keys
    (``tests/test_serve.py::_oracle``), in float64."""
    if case["kind"] == "paged":
        k, v, kpos = logical_view(case)
    else:
        k, v, kpos = case["k"], case["v"], case["kpos"]
    q, qpos, window = case["q"], case["qpos"], case["window"]
    b, _, h, dk = q.shape
    g = h // k.shape[2]
    out = np.zeros((b, 1, h, v.shape[3]), np.float64)
    for bi in range(b):
        mask = (kpos[bi] >= 0) & (kpos[bi] <= qpos[bi])
        if window is not None:
            mask &= kpos[bi] > qpos[bi] - window
        if not mask.any():
            continue
        for hi in range(h):
            s = (k[bi, mask, hi // g].astype(np.float64)
                 @ q[bi, 0, hi].astype(np.float64)) * dk ** -0.5
            w = np.exp(s - s.max())
            w /= w.sum()
            out[bi, 0, hi] = w @ v[bi, mask, hi // g]
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# the serving main path's shapes (run in bf16 on the card)
# ---------------------------------------------------------------------------


MAIN_PATH = ("gemma3_1b_ring", "gemma3_1b_paged", "stablelm_dense",
             "stablelm_paged", "recurrentgemma_2b_ring",
             "recurrentgemma_2b_paged", "moonshot_v1_16b_a3b_paged",
             "internvl2_1b_dense", "internvl2_1b_paged")
# the timed large shape: 64 slots x 8192 cached tokens at stablelm width
# (4.3 GB of bf16 K/V), made on the card by chip_smoke.py
LARGE_SHAPE = dict(b=64, s=8192, kh=32, g=1, d=64, page_size=64)


def main_path_cases(seed=0):
    """gemma3-1b (K=1, G=4, D=256): its ring layers' dense decode over a
    512-row window after ~700 tokens, and its global layers' paged decode
    over 64-token pages; stablelm-1.6b width (K=32, G=1, D=64): dense
    (bounded) and paged. Eight slots, ragged positions 540-700.
    recurrentgemma-2b (K=1, G=10, D=256) as its serving phase runs it:
    its local layers' 2048-row rings (max_len 4096, window 2048) at
    positions 96-176, and paged over 64-token pages at the same positions
    (max_len 1024). moonshot-v1-16b-a3b (K=16, G=1, D=128): paged over
    64-token pages at those positions (max_len 1024), as its serving phase
    runs it. internvl2-1b (K=2, G=7, D=64): a dense cache of 1024 rows
    (max_len 1024) at those positions, as its serving phase runs it, and
    paged over 64-token pages."""
    rng = np.random.default_rng(seed)
    b = 8
    qpos = rng.integers(540, 701, size=b).astype(np.int32)
    cases = {}
    # gemma3-1b local layers: ring of 512 rows, window 512
    q, k, v = _rand_qkv(rng, b, 512, 4, 1, 256)
    cases["gemma3_1b_ring"] = _dense(q, k, v, qpos, ring_kpos(qpos + 1, 512),
                                     window=512, bounded=False)
    # gemma3-1b global layers: 16 pages of 64 per slot (max_len 1024)
    cases["gemma3_1b_paged"] = _paged_main(rng, qpos, kh=1, h=4, d=256)
    # stablelm-1.6b: a dense cache of 1024 rows, and paged
    q, k, v = _rand_qkv(rng, b, 1024, 32, 32, 64)
    cases["stablelm_dense"] = _dense(q, k, v, qpos, dense_kpos(qpos, 1024))
    cases["stablelm_paged"] = _paged_main(rng, qpos, kh=32, h=32, d=64)
    qpos = rng.integers(96, 177, size=b).astype(np.int32)
    q, k, v = _rand_qkv(rng, b, 2048, 10, 1, 256)
    cases["recurrentgemma_2b_ring"] = _dense(
        q, k, v, qpos, ring_kpos(qpos + 1, 2048), window=2048, bounded=False)
    cases["recurrentgemma_2b_paged"] = _paged_main(rng, qpos, kh=1, h=10,
                                                   d=256)
    cases["moonshot_v1_16b_a3b_paged"] = _paged_main(rng, qpos, kh=16,
                                                     h=16, d=128)
    q, k, v = _rand_qkv(rng, b, 1024, 14, 2, 64)
    cases["internvl2_1b_dense"] = _dense(q, k, v, qpos,
                                         dense_kpos(qpos, 1024))
    cases["internvl2_1b_paged"] = _paged_main(rng, qpos, kh=2, h=14, d=64)
    return cases


def _paged_main(rng, qpos, *, kh, h, d, page_size=64, pages_per_slot=16):
    b = len(qpos)
    n_pages = b * pages_per_slot + 1
    pool_k = rng.standard_normal((n_pages, page_size, kh, d)).astype(np.float32)
    pool_v = rng.standard_normal((n_pages, page_size, kh, d)).astype(np.float32)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    table = bind_pages(qpos, page_size, pages_per_slot, n_pages,
                       np.random.RandomState(1))
    return dict(kind="paged", q=q, k=pool_k, v=pool_v,
                qpos=np.asarray(qpos, np.int32), table=table, window=None,
                empty=())


def valid_keys(case):
    """Number of (slot, key) pairs the kernel must read: the bytes bound."""
    if case["kind"] == "paged":
        _, _, kpos = logical_view(case)
    else:
        kpos = case["kpos"]
    qpos = case["qpos"][:, None]
    mask = (kpos >= 0) & (kpos <= qpos)
    if case["window"] is not None:
        mask &= kpos > qpos - case["window"]
    return int(mask.sum())
