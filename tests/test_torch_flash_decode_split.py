"""The flash-decode kernels' split of each slot's key range over blocks, on
the CPU, against the JAX package.

The kernels take a (split, KV head, slot) a block and merge the splits'
partial softmax states by log-sum-exp in the same launch. Here plain
versions of both halves, ``split_partial`` / ``split_partial_paged`` (one
split, the port's online-softmax block over its rows) and
``merge_partials`` (the merge in split order), run over every case of ``tests/_flash_decode_cases.py`` at 1, 2 and 3 splits and at
one split per tile or page, and are held to the JAX Pallas kernels in
interpret mode and their XLA twins within 2e-5 in float32; empty lanes
must come out exactly zero. ``split_plan``, the wrapper's choice of split,
is checked as a pure function of shapes.
"""
import functools
import inspect
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _flash_decode_cases import (ATOL_F32, CASES, LARGE_SHAPE,
                                 main_path_cases)
from repro.kernels import flash_decode as jfd
from repro_torch.kernels import flash_decode as fd

SPLITS = ("1", "2", "3", "per_unit")
H100_SMS = 132


# ---------------------------------------------------------------------------
# plain versions of one split and of the merge
# ---------------------------------------------------------------------------


def split_rows(plan, unit_rows, rows):
    """The row range [start, end) of each split of ``plan``."""
    n, per = plan
    return [(i * per * unit_rows, min(rows, (i + 1) * per * unit_rows))
            for i in range(n)]


def _empty_state(b, kh, g, dv):
    return (torch.full((b, kh, g), fd.NEG_INF, dtype=torch.float32),
            torch.zeros((b, kh, g), dtype=torch.float32),
            torch.zeros((b, kh, g, dv), dtype=torch.float32))


def split_partial(q, k, v, q_positions, k_positions, *, rows, window):
    """One split of the dense kernel: the online softmax over cache rows
    ``[start, end)`` of every slot, unnormalised. Returns (m, l) (B, K, G)
    and acc (B, K, G, Dv), float32; a split with no attended key gives
    (NEG_INF, 0, 0)."""
    b, _, h, dk = q.shape
    kh, dv = k.shape[2], v.shape[3]
    qp = q_positions.to(torch.int32)[:, None]
    kpos = k_positions.to(torch.int32)
    qh = q[:, 0].reshape(b, kh, h // kh, dk).float()
    m, l, acc = _empty_state(b, kh, h // kh, dv)
    for lo in range(rows[0], rows[1], fd.TILE):
        blk = slice(lo, min(lo + fd.TILE, rows[1]))
        kp = kpos[:, blk]
        mask = (kp >= 0) & (kp <= qp)
        if window is not None:
            mask &= kp > qp - window
        m, l, acc = fd._online_softmax_block(
            qh, k[:, blk].float(), v[:, blk].float(), mask,
            1.0 / math.sqrt(dk), m, l, acc)
    return m, l, acc


def split_partial_paged(q, pool_k, pool_v, q_positions, page_table, *,
                        pages, window):
    """One split of the paged kernel: the online softmax over logical pages
    ``[start, end)`` of every slot's table row, as :func:`split_partial`."""
    b, _, h, dk = q.shape
    page_size, kh = pool_k.shape[1], pool_k.shape[2]
    qp = q_positions.to(torch.int32)[:, None]
    qh = q[:, 0].reshape(b, kh, h // kh, dk).float()
    table = page_table.to(torch.int32)
    offs = torch.arange(page_size, dtype=torch.int32)
    m, l, acc = _empty_state(b, kh, h // kh, pool_v.shape[3])
    for i in range(*pages):
        bound = table[:, i]
        phys = torch.clamp_min(bound, 0).long()
        kp = (i * page_size + offs)[None, :]
        mask = (bound >= 0)[:, None] & (kp <= qp)
        if window is not None:
            mask &= kp > qp - window
        m, l, acc = fd._online_softmax_block(
            qh, pool_k[phys].float(), pool_v[phys].float(), mask,
            1.0 / math.sqrt(dk), m, l, acc)
    return m, l, acc


def merge_partials(parts):
    """The kernels' merge: the splits' (m, l, acc) merged by log-sum-exp in
    split order and normalised -> (B, K, G, Dv) float32. A split with l = 0
    adds nothing; if every split is empty the result is acc / max(l, 1e-37)
    = exact zeros, as the Pallas kernel's _finalize."""
    live = [(m, l > 0) for m, l, _ in parts]
    mx = torch.full_like(parts[0][0], fd.NEG_INF)
    for m, ok in live:
        mx = torch.where(ok, torch.maximum(mx, m), mx)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for (m, l, a), (_, ok) in zip(parts, live):
        w = torch.where(ok, torch.exp(m - mx), torch.zeros_like(mx))
        l_sum = l_sum + l * w
        acc = acc + a * w[..., None]
    return acc / torch.clamp_min(l_sum[..., None], 1e-37)


@functools.lru_cache(maxsize=None)
def _jax_outputs(name):
    """The JAX Pallas kernel (interpret mode) and XLA twin on the case."""
    case = CASES[name]()
    q = jnp.asarray(case["q"])
    k, v = jnp.asarray(case["k"]), jnp.asarray(case["v"])
    qpos = jnp.asarray(case["qpos"])
    if case["kind"] == "paged":
        table = jnp.asarray(case["table"])
        kw = dict(window=case["window"])
        out = {"pallas": jfd.flash_decode_paged(q, k, v, qpos, table,
                                                interpret=True, **kw),
               "xla": jfd.flash_decode_paged_xla(q, k, v, qpos, table, **kw)}
    else:
        kpos = jnp.asarray(case["kpos"])
        kw = dict(window=case["window"], block_k=case["block_k"])
        out = {"pallas": jfd.flash_decode(q, k, v, qpos, kpos,
                                          interpret=True, **kw),
               "xla": jfd.flash_decode_xla(q, k, v, qpos, kpos,
                                           bounded=case["bounded"], **kw)}
    return {n: np.asarray(o) for n, o in out.items()}


def _units(case):
    """(units, rows per unit, rows) of the case's key range, as the
    wrapper counts them: tiles of the dense cache, pages of the paged."""
    if case["kind"] == "paged":
        ps = case["k"].shape[1]
        n_pages = case["table"].shape[1]
        return n_pages, ps, n_pages * ps
    s = case["k"].shape[1]
    return -(-s // fd.TILE), fd.TILE, s


def _partials(case, ranges):
    """One plain partial (m, l, acc) per split range, in split order."""
    t = {n: torch.from_numpy(case[n]) for n in ("q", "k", "v", "qpos")}
    parts = []
    for lo, hi in ranges:
        if case["kind"] == "paged":
            ps = case["k"].shape[1]
            parts.append(split_partial_paged(
                t["q"], t["k"], t["v"], t["qpos"],
                torch.from_numpy(case["table"]), pages=(lo // ps, hi // ps),
                window=case["window"]))
        else:
            parts.append(split_partial(
                t["q"], t["k"], t["v"], t["qpos"],
                torch.from_numpy(case["kpos"]), rows=(lo, hi),
                window=case["window"]))
    return parts


def _ranges(case, split):
    n_units, unit_rows, rows = _units(case)
    n = n_units if split == "per_unit" else int(split)
    return split_rows(fd.even_split(n_units, n), unit_rows, rows)


def _merged(case, parts):
    b, _, h, _ = case["q"].shape
    dv = case["v"].shape[3]
    return merge_partials(parts).reshape(b, 1, h, dv).numpy()


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_and_merge_match_jax(name, split):
    case = CASES[name]()
    ranges = _ranges(case, split)
    got = _merged(case, _partials(case, ranges))
    assert np.isfinite(got).all()
    for which, want in _jax_outputs(name).items():
        np.testing.assert_allclose(got, want, atol=ATOL_F32, err_msg=which)
    for lane in case["empty"]:
        np.testing.assert_array_equal(got[lane], 0.0)   # exact zeros


@pytest.mark.parametrize("name", ["long_sparse", "window_inside_splits",
                                  "paged_gaps", "paged_window_unbound",
                                  "no_valid_key"])
def test_wholly_masked_split_changes_nothing(name):
    """A split with no attended key for a slot (past q_pos, before the
    window, on unbound pages) leaves the exact empty partial there, and the
    merge without it is bit-identical for that slot."""
    case = CASES[name]()
    parts = _partials(case, _ranges(case, "per_unit"))
    full = _merged(case, parts)
    masked = 0
    for i, (m, l, acc) in enumerate(parts):
        empty = (l == 0).all(dim=(1, 2))            # (B,) slots
        for bi in torch.nonzero(empty).flatten().tolist():
            masked += 1
            assert (m[bi] == fd.NEG_INF).all() and (acc[bi] == 0).all()
            rest = parts[:i] + parts[i + 1:]
            if rest:
                np.testing.assert_array_equal(_merged(case, rest)[bi],
                                              full[bi])
    assert masked > 0


def test_merge_ignores_an_empty_partial_anywhere():
    case = CASES["window_inside_splits"]()
    parts = _partials(case, _ranges(case, "3"))
    m, l, acc = parts[0]
    empty = (torch.full_like(m, fd.NEG_INF), torch.zeros_like(l),
             torch.zeros_like(acc))
    want = _merged(case, parts)
    for at in range(len(parts) + 1):
        np.testing.assert_array_equal(
            _merged(case, parts[:at] + [empty] + parts[at:]), want)
    np.testing.assert_array_equal(_merged(case, [empty, empty]), 0.0)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def test_split_plan_reads_only_shapes():
    """The plan's inputs are four integers: it cannot need a position."""
    assert list(inspect.signature(fd.split_plan).parameters) == [
        "n_units", "unit_rows", "pairs", "n_sm"]
    # the wrapper's helper passes it the SM count, nothing of the call's data
    assert list(inspect.signature(fd._plan).parameters) == [
        "device", "n_units", "unit_rows", "pairs"]


SHAPES = [  # (rows or pages, unit rows, pairs, SMs)
    *[(-(-s // fd.TILE), fd.TILE, pairs, sms)
      for s in (1, 31, 32, 33, 96, 512, 1000, 1024, 4096, 8192)
      for pairs in (1, 3, 8, 256, 2048) for sms in (1, 132)],
    *[(pages, ps, pairs, sms)
      for pages, ps in ((1, 64), (16, 64), (128, 64), (4, 8), (12, 8),
                        (8, 4), (7, 1), (2, 256))
      for pairs in (1, 8, 256, 2048) for sms in (1, 132)],
]


@pytest.mark.parametrize("n_units,unit_rows,pairs,n_sm", SHAPES)
def test_split_plan_covers_every_row_once(n_units, unit_rows, pairs, n_sm):
    rows = n_units * unit_rows
    plan = fd.split_plan(n_units, unit_rows, pairs, n_sm)
    n, per = plan
    assert 1 <= n <= fd.MAX_SPLIT and (n - 1) * per < n_units <= n * per
    ranges = split_rows(plan, unit_rows, rows)
    covered = np.zeros(rows, np.int64)
    for lo, hi in ranges:
        assert lo < hi                      # no split is empty by shape
        assert lo % unit_rows == 0          # on a tile or page boundary
        covered[lo:hi] += 1
    assert (covered == 1).all()
    if pairs >= fd.BLOCKS_PER_SM * n_sm:    # the pairs fill the card
        assert n == 1


def test_split_plan_at_the_main_path_shapes():
    """gemma3-1b (8 slots, one KV head): 16 splits of one 32-row tile on the
    ring, 16 of one page on the paged cache, so 128 blocks on the H100's
    132 SMs; the stablelm width (256 pairs) splits in 3; recurrentgemma-2b
    (G = 10: two head groups a KV head, so 16 pairs) 16 ways, four tiles of
    its 2048-row ring or one page a split; moonshot-v1-16b-a3b (128 pairs)
    4 ways of 4 pages; internvl2-1b (two KV heads, G = 7 in one head
    group, so 16 pairs) 16 ways, two tiles of its 1024-row cache or one
    page a split; the large shape (2048 pairs) does not split."""
    cases = main_path_cases()
    got = {}
    for name, case in cases.items():
        n_units, unit_rows, _ = _units(case)
        b, h = case["q"].shape[0], case["q"].shape[2]
        kh = case["k"].shape[2]
        got[name] = fd.split_plan(n_units, unit_rows,
                                  b * kh * fd.head_groups(h // kh), H100_SMS)
    assert got == {"gemma3_1b_ring": (16, 1), "gemma3_1b_paged": (16, 1),
                   "stablelm_dense": (3, 11), "stablelm_paged": (3, 6),
                   "recurrentgemma_2b_ring": (16, 4),
                   "recurrentgemma_2b_paged": (16, 1),
                   "moonshot_v1_16b_a3b_paged": (4, 4),
                   "internvl2_1b_dense": (16, 2),
                   "internvl2_1b_paged": (16, 1)}
    c = LARGE_SHAPE
    pairs = c["b"] * c["kh"]
    assert fd.split_plan(c["s"] // fd.TILE, fd.TILE, pairs, H100_SMS) == (
        1, c["s"] // fd.TILE)
    assert fd.split_plan(c["s"] // c["page_size"], c["page_size"], pairs,
                         H100_SMS) == (1, c["s"] // c["page_size"])


def test_constants_match_the_cuda_source():
    """The wrapper's tile, split and shape limits are the kernel's."""
    src = (Path(fd.__file__).parent / "csrc" / "flash_decode.cu").read_text()
    for name, value in (("TILE", fd.TILE), ("MAX_SPLIT", fd.MAX_SPLIT),
                        ("MAX_G", fd.MAX_G), ("GROUP_G", fd.GROUP_G),
                        ("MAX_D", fd.MAX_D)):
        found = re.search(rf"constexpr int {name} = (\d+);", src)
        assert found and int(found.group(1)) == value, name
