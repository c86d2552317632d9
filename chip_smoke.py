#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper GPU.

Drives the port's two main paths through ``repro_torch.cluster.KsaCluster.
run_campaign``: the AlphaKnot campaign at the paper's batch size (4000
structures per task) on 512-point backbones, and the serving decode path
(tokenize -> generate -> postprocess) on gemma3-1b at full width. It builds
every CUDA kernel of those paths from this checkout, holds each against its
plain PyTorch version on the card, and times it beside its bound. Phases:

1. environment: torch, CUDA, nvcc, the card (nvidia-smi), msgpack;
2. build: nvcc for sm_90a, with the build time and ptxas' report;
3. kernel against plain on the card, atol 6e-4 / rtol 1e-3 (the tolerance
   of tests/test_kernels.py) element by element, and within 2e-4 of the
   plain version in float64 in the Frobenius norm relative to its map's;
   the kernel's map exactly symmetric; then the screen and the localization
   on the card against the same on the CPU, each knotted structure's total
   writhe within a relative 3e-4 of the plain version's in float64;
4. timing at B=4000, n=512: kernel, plain version (in the largest chunks
   that fit, each chunk checked against the kernel) and the bound;
5. a breakdown of one batch's host and device work;
6. the main path: an 8000-structure campaign (two screen tasks of 4000),
   then the flat ``knot_batch`` baseline on the same ids; their knotted
   sets and knot cores must be equal, and the kernel must have run;
7. build of the flash-decode kernels (started beside the writhe build in
   phase 2), with the build time and ptxas' report;
8. flash-decode kernels against their plain versions on the card: the
   cases of tests/test_serve.py in float32 at atol 2e-5 (empty lanes
   exactly zero), then the main path's shapes in bf16 against the plain
   version in float32 on the same bf16 inputs at 2e-2;
9. flash-decode timing at the main path's shapes and at B=64 x 8192 keys
   (stablelm width): kernel, plain version, one
   ``scaled_dot_product_attention`` call as the yardstick, and the bound;
10. the serving main path: gemma3-1b at full width in bf16 (random weights
   from ``init_params``), a paged flash ``ServeEngine`` behind
   ``serve_pipeline``: 16 requests answered with 16 tokens each, every page
   returned, and exactly 22 dense and 4 paged kernel launches per step;
11. exactness at full width in float32: dense chunked (the reference),
   dense flash and paged flash engines give the same greedy tokens.

The last three lines of its output are the kernels line (JSON), the card's
name and power limit as nvidia-smi gives them, and the result line (JSON).
It exits non-zero, and prints no result, when CUDA is unavailable, when the
repository's sources are missing, or when any phase fails.

Run from the root of a checkout:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ATOL, RTOL, SYM = 6e-4, 1e-3, 1e-4
# against the plain version in float64: the Frobenius norm of the error
# relative to the map's, and each knotted structure's total writhe,
# relative. fp32 itself sets the floor: asinf near +-1 turns one ulp of a
# dot product into ~3e-4 of solid angle, so at 512 points the plain version
# in fp32 is itself about 1e-4 from float64; phase 3 prints its figures
# beside the kernel's
FROB, WR_REL = 2e-4, 3e-4
B_FULL, N_POINTS = 4000, 512       # the paper's batch; backbone length
CAMPAIGN = 8000                    # two screen tasks of B_FULL
# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and fp32 (non-tensor) FLOP/s
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# fp32 operations per off-band segment pair in csrc/writhe.cu (an FMA is
# two): differences 12, cross products 4x9, normalisations 4x11 (dot, +eps,
# sqrt, divide, 3 scales), dots 4x5, clips 4x2, asin 4, sum 3, the sign's
# two differences 6, cross 9, dot 5 and 2 compares, the scale 3
OPS_PER_PAIR = 12 + 36 + 44 + 20 + 8 + 4 + 3 + 6 + 9 + 5 + 2 + 3


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phases -------------------------------------------------------------------

def phase_environment(build) -> str:
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True, timeout=60, check=True)
    log("nvcc:", nv.stdout.strip().splitlines()[-1])
    smi = nvidia_smi()
    log("nvidia-smi name, power.limit:", smi)
    log(f"device: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, capability "
        f"{torch.cuda.get_device_capability(0)}")
    try:
        import msgpack
        log("msgpack: imports, version", msgpack.version)
    except ImportError:
        log("msgpack: not installed (the in-memory broker does not need it)")
    return smi


def report_build(name: str, res) -> None:
    how = f"built in {res.seconds:.2f} s" if res.seconds else "up to date"
    log(f"build {name}.cu: {how} -> {res.path.relative_to(ROOT)}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())


def phase_build(build, writhe, pool):
    """Both sources compile at once, one nvcc each; the writhe build is
    reported here, the flash-decode one in phase 7."""
    pending = {name: pool.submit(build.build, name)
               for name in ("writhe", "flash_decode")}
    report_build("writhe", pending["writhe"].result())
    writhe._library()
    return pending["flash_decode"]


def frobenius_rel(got: torch.Tensor, exact: torch.Tensor) -> float:
    """||got - exact||_F / ||exact||_F; 0 when both are all zero."""
    num = float((got.double() - exact).square().sum())
    den = float(exact.square().sum())
    if den == 0.0:
        return 0.0 if num == 0.0 else float("inf")
    return (num / den) ** 0.5


def check_case(writhe, name: str, coords: np.ndarray) -> float:
    x = torch.from_numpy(np.ascontiguousarray(coords, np.float32)).cuda()
    got = writhe.writhe_map(x)
    torch.cuda.synchronize()
    want = writhe.writhe_map_ref(x)
    exact = writhe.writhe_map_ref(x.double())
    m = max(coords.shape[1] - 1, 0)
    assert got.shape == want.shape == (coords.shape[0], m, m), got.shape
    assert bool(torch.isfinite(got).all()), name
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    # the norm check holds the small far-field entries (well under ATOL)
    rel, rel_plain = frobenius_rel(got, exact), frobenius_rel(want, exact)
    assert rel <= FROB, (name, rel, rel_plain)
    norm = float(exact.norm())
    share = float(exact[exact.abs() < ATOL].norm()) / norm if norm else 0.0
    asym = float((got - got.transpose(1, 2)).abs().max()) if got.numel() else 0.0
    assert asym <= SYM, (name, asym)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    log(f"  {name:<24} {tuple(coords.shape)}: max |kernel - plain| "
        f"{err:.3g}; against fp64, ||.||_F relative: kernel {rel:.3g}, "
        f"plain fp32 {rel_plain:.3g}; entries under ATOL hold {share:.3g} "
        f"of ||W||_F; max |W - W^T| {asym:.3g}  ok")
    return err


def phase_check(knots, writhe) -> float:
    rng = np.random.RandomState(0)
    lattice = np.cumsum(rng.randint(-1, 2, size=(2, 200, 3)), 1)
    lattice[:, 50:60] = lattice[:, 49:50]      # a run of repeated points
    cases = {
        "synthesize_batch 64": knots.synthesize_batch(range(64), N_POINTS)[0],
        "random walk 34": np.cumsum(rng.randn(3, 34, 3), 1),
        "random walk 130": np.cumsum(rng.randn(3, 130, 3), 1),
        "repeated points": lattice,
        "straight chain": np.arange(300)[None, :, None] * np.array([1.0, 2.0, -0.5]),
        "B=0": np.zeros((0, N_POINTS, 3)),
    }
    errs = [check_case(writhe, name, c) for name, c in cases.items()]
    return max(errs)


def phase_parity(knots, writhe) -> None:
    """The screen and the localization on the card against the same on the
    CPU (the plain version, which the CPU tests hold to the JAX package):
    kept, knotted and cores must be equal, the mean ACN within 1e-5, and
    each knotted structure's total writhe within a relative WR_REL of the
    plain version's in float64."""
    for n_ids, n_points in ((48, 96), (64, 128), (64, N_POINTS)):
        ids = list(range(n_ids))
        gpu = knots._screen_batch(ids, n_points, False, device="cuda")
        cpu = knots._screen_batch(ids, n_points, False, device="cpu")
        assert gpu[:2] == cpu[:2], ("screen", n_points)
        assert gpu[2].keys() == cpu[2].keys() and cpu[2], ("wr", n_points)
        coords, _ = knots.synthesize_batch([int(k) for k in cpu[2]], n_points)
        exact = writhe.writhe_map_ref(
            torch.from_numpy(coords).cuda().double()).sum(dim=(1, 2)) / 2
        exact = dict(zip(cpu[2], exact.tolist()))
        wr_card, wr_cpu = (max(abs(side[k] - w) / abs(w)
                               for k, w in exact.items())
                           for side in (gpu[2], cpu[2]))
        assert wr_card <= WR_REL, (n_points, wr_card, wr_cpu)
        assert abs(gpu[3] - cpu[3]) <= 1e-5 * abs(cpu[3]), (gpu[3], cpu[3])
        cores = [knots._localize_cores(gpu[1], n_points, False, lambda: None,
                                       device=d) for d in ("cuda", "cpu")]
        assert cores[0] == cores[1], ("cores", n_points)
        log(f"  ids 0-{n_ids - 1} at {n_points} points: kept {len(gpu[0])}, "
            f"knotted {len(gpu[1])}, cores {len(cores[0])}: card == CPU; "
            f"total writhe against fp64, max relative: card {wr_card:.3g}, "
            f"CPU {wr_cpu:.3g}  ok")


def bound(b: int, n: int) -> tuple[float, str, dict]:
    m = n - 1
    # W is symmetric, so the function needs each unordered off-band segment
    # pair (|i-j| > 1) once; its mirror is a copy
    pairs = b * (m * m - 3 * m + 2) // 2
    nbytes = b * n * 3 * 4 + b * m * m * 4     # read coords once, write W once
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = pairs * OPS_PER_PAIR / FP32_FLOP_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "pairs": pairs,
                                     "ops": pairs * OPS_PER_PAIR,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def phase_timing(knots, writhe) -> dict:
    t0 = time.perf_counter()
    coords, _ = knots.synthesize_batch(range(B_FULL), N_POINTS)
    log(f"  synthesize_batch({B_FULL}, {N_POINTS}): "
        f"{time.perf_counter() - t0:.2f} s on the host")
    x = torch.from_numpy(coords).cuda()
    out = writhe.writhe_map(x)
    ms = median_ms(lambda: writhe.writhe_map(x), reps=10)
    bound_ms, bound_by, parts = bound(B_FULL, N_POINTS)
    log(f"  kernel ({B_FULL}, {N_POINTS}, 3): median {ms:.3f} ms over 10; "
        f"bound {bound_ms:.3f} ms ({bound_by}: {parts['ops']:.4g} fp32 ops "
        f"-> {parts['ops_ms']:.3f} ms, {parts['bytes']:.4g} bytes -> "
        f"{parts['bytes_ms']:.3f} ms); {bound_ms / ms:.1%} of the bound, "
        f"{parts['ops'] / ms / 1e9:.1f} TFLOP/s, "
        f"{parts['bytes'] / ms / 1e6:.0f} GB/s")

    # the plain version at the largest chunk that fits, sized from its peak
    # memory per structure, checked chunk by chunk against the kernel's map
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    probe = 8
    writhe.writhe_map_ref(x[:probe])
    per = (torch.cuda.max_memory_allocated() - base) / probe
    free = torch.cuda.mem_get_info()[0]
    chunk = int(max(8, min(B_FULL, 0.6 * free / per)) // 8 * 8)
    log(f"  plain version: {per / 2**20:.0f} MiB peak per structure, "
        f"{free / 2**30:.1f} GiB free -> chunks of {chunk}")
    one_ms = median_ms(lambda: writhe.writhe_map_ref(x[:chunk]), reps=3,
                       warmup=1)
    plain_ms, err = 0.0, 0.0
    for s in range(0, B_FULL, chunk):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = writhe.writhe_map_ref(x[s:s + chunk])
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        got = out[s:s + chunk]
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        err = max(err, float((got - want).abs().max()))
        del want
    assert torch.equal(out, out.transpose(1, 2)), "kernel map not symmetric"
    log(f"  plain ({chunk}, {N_POINTS}, 3): median {one_ms:.3f} ms over 3; "
        f"all {B_FULL} in chunks: {plain_ms:.3f} ms; full-size check: max "
        f"|kernel - plain| {err:.3g}  ok")
    return {"ms": ms, "plain_ms": plain_ms, "plain_chunk": chunk,
            "plain_chunk_ms": one_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def phase_breakdown(knots, writhe) -> None:
    """Where one screen + localize batch spends its time, piece by piece."""
    ids = list(range(B_FULL))
    t0 = time.perf_counter()
    knots.quality_score(ids)
    t1 = time.perf_counter()
    coords, _ = knots.synthesize_batch(ids, N_POINTS)
    t2 = time.perf_counter()
    x = torch.from_numpy(coords).cuda()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    wr, acn, w = knots.writhe_and_acn(x)
    wr.cpu()
    acn.cpu()
    t4 = time.perf_counter()
    block = w[:knots.HOST_BLOCK].cpu().numpy()
    t5 = time.perf_counter()
    for k in range(len(block)):
        knots.knot_core(block[k])
    t6 = time.perf_counter()
    per_core = (t6 - t5) / len(block) * 1e3
    per_d2h = (t5 - t4) / len(block) * 1e3
    log(f"  quality_score {t1 - t0:.3f} s | synthesize_batch {t2 - t1:.3f} s "
        f"| H2D {t3 - t2:.3f} s | writhe_and_acn {t4 - t3:.3f} s | "
        f"D2H {per_d2h:.3f} ms/structure | knot_core {per_core:.3f} "
        f"ms/structure (host clock, {B_FULL} x {N_POINTS})")


def phase_main_path(knots, writhe, KsaCluster) -> int:
    ids = list(range(CAMPAIGN))
    writhe.writhe_map.launches = 0         # count only the main path's run
    with KsaCluster(workers=1, gpu_workers=1) as c:
        spec = knots.knots_pipeline(B_FULL, n_points=N_POINTS,
                                    gpu_localize=True)
        res = c.run_campaign(spec, ids, timeout_s=900.0)
        launches = writhe.writhe_map.launches
        agg = res.final
        assert res.status.state == "COMPLETED", res.status.state
        assert agg["processed"] == CAMPAIGN, agg["processed"]
        screens = [r for r in res.results["screen"] if r]
        locs = [r for r in res.results.get("localize", []) if r]
        with_work = (sum(1 for r in screens if r["kept"])
                     + sum(1 for r in locs if r["candidates"]))
        log(f"  campaign: {CAMPAIGN} structures in {res.elapsed_s:.2f} s "
            f"({CAMPAIGN / res.elapsed_s:.1f} structures/s); kept "
            f"{agg['kept']}, knotted {len(agg['knotted'])}, cores "
            f"{len(agg['cores'])}, batches {agg['batches']}, mean ACN "
            f"{agg['mean_acn']:.4f}")
        rep = c.campaign_report(res.campaign_id)
        for name, s in rep["stages"].items():
            log(f"    stage {name:>9}: {s['tasks']} tasks, queue "
                f"{s['queue_s']:.2f} s, run {s['run_s']:.2f} s, wall "
                f"{s['wall_s']:.2f} s")
        log(f"  writhe launches in the campaign: {launches} "
            f"(screen + localize tasks with work: {with_work})")
        assert launches >= with_work > 0, (launches, with_work)

        t0 = time.perf_counter()
        tids = c.submit_batches("knot_batch", ids, batch_size=B_FULL,
                                params={"n_points": N_POINTS, "stage2": True})
        assert c.wait_all(tids, timeout=900.0), "flat baseline stalled"
        flat_s = time.perf_counter() - t0
        knotted, cores, flat_work = set(), {}, 0
        for t in tids:
            r = c.result(t)
            knotted.update(r["knotted"])
            cores.update(r["cores"])
            flat_work += bool(r["kept"]) + bool(r["knotted"])
        flat_launches = writhe.writhe_map.launches - launches
        log(f"  flat knot_batch: {len(tids)} tasks in {flat_s:.2f} s "
            f"({CAMPAIGN / flat_s:.1f} structures/s); writhe launches "
            f"{flat_launches} (with work: {flat_work})")
        assert flat_launches >= flat_work > 0, (flat_launches, flat_work)
    assert sorted(knotted) == agg["knotted"], "knotted sets differ"
    assert cores == agg["cores"], "knot cores differ"
    log(f"  campaign == flat baseline: {len(knotted)} knotted, "
        f"{len(cores)} cores  ok")
    return launches


# -- the serving decode path (phases 7-11) ------------------------------------

FD_ATOL_F32, FD_ATOL_BF16 = 2e-5, 2e-2     # tests/test_serve.py, test_kernels
SERVE_ARCH = "gemma3_1b"
N_TEXTS, MAX_NEW, N_EXACT, MAX_NEW_EXACT = 16, 16, 4, 8
LARGE = dict(b=64, s=8192, kh=32, g=1, d=64, page_size=64)
L2_BYTES = 64 << 20                        # more than the 50 MB L2


def phase_flash_build(fd, pending) -> None:
    report_build("flash_decode", pending.result())
    fd._library()


def _fd_inputs(case, dtype):
    dev = "cuda"
    t = {n: torch.from_numpy(case[n]).to(dev, dtype) for n in ("q", "k", "v")}
    t["qpos"] = torch.from_numpy(case["qpos"]).to(dev)
    idx = "table" if case["kind"] == "paged" else "kpos"
    t[idx] = torch.from_numpy(case[idx]).to(dev)
    return t


def _fd_call(fd, case, t, plain=False):
    if case["kind"] == "paged":
        fn = fd.flash_decode_paged_ref if plain else fd.flash_decode_paged
        return fn(t["q"], t["k"], t["v"], t["qpos"], t["table"],
                  window=case["window"])
    fn = fd.flash_decode_ref if plain else fd.flash_decode
    return fn(t["q"], t["k"], t["v"], t["qpos"], t["kpos"],
              window=case["window"], bounded=case["bounded"])


def _fd_name(case) -> str:
    return "flash_decode_paged" if case["kind"] == "paged" else "flash_decode"


def phase_flash_check(fd, fdc) -> dict:
    """Kernel against plain on the card: every case of tests/test_serve.py
    in float32, then the main path's shapes in bf16."""
    err = {"flash_decode": 0.0, "flash_decode_paged": 0.0}
    err_f32 = dict(err)
    for name, make in fdc.CASES.items():
        case = make()
        t = _fd_inputs(case, torch.float32)
        got = _fd_call(fd, case, t)
        torch.cuda.synchronize()
        want = _fd_call(fd, case, t, plain=True)
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=FD_ATOL_F32, rtol=0)
        oracle = torch.from_numpy(fdc.oracle(case)).to(got.device)
        torch.testing.assert_close(got, oracle, atol=FD_ATOL_F32, rtol=0)
        for lane in case["empty"]:
            assert bool((got[lane] == 0).all()), (name, lane)
        e = float((got - want).abs().max())
        err_f32[_fd_name(case)] = max(err_f32[_fd_name(case)], e)
        log(f"  f32 {name:<22} {_fd_name(case):<18} max |kernel - plain| "
            f"{e:.3g}, empty lanes {list(case['empty'])} exactly 0  ok")
    for name, case in fdc.main_path_cases().items():
        t = _fd_inputs(case, torch.bfloat16)
        got = _fd_call(fd, case, t)
        torch.cuda.synchronize()
        t32 = dict(t, q=t["q"].float(), k=t["k"].float(), v=t["v"].float())
        want = _fd_call(fd, case, t32, plain=True)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, atol=FD_ATOL_BF16,
                                   rtol=FD_ATOL_BF16)
        e = float((got.float() - want).abs().max())
        err[_fd_name(case)] = max(err[_fd_name(case)], e)
        log(f"  bf16 {name:<21} {_fd_name(case):<18} q {tuple(case['q'].shape)}"
            f" k {tuple(case['k'].shape)}: max |kernel - plain fp32| {e:.3g}"
            f"  ok")
    return {k: max(err[k], err_f32[k]) for k in err} | {
        f"{k}_f32": v for k, v in err_f32.items()}


def _median_flushed(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` (CUDA events), the L2 cache flushed
    before each timed run, as a decode step finds it after other layers."""
    scratch = torch.empty(L2_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _fd_bound(valid_pairs: int, kh: int, g: int, dk: int, dv: int, b: int,
              index_ints: int, elem: int) -> tuple[float, str, dict]:
    """Least time: each valid K/V row (all KV heads) read once, q and the
    output once, the positions or table once; the operations are the two
    products per valid key and query head, in fp32 (no tensor cores)."""
    nbytes = (valid_pairs * kh * (dk + dv) * elem
              + b * kh * g * (dk + dv) * elem + b * 4 + index_ints * 4)
    ops = valid_pairs * kh * g * 2 * (dk + dv)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / FP32_FLOP_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "ops": ops}


def _sdpa_inputs(case, t):
    """(B, H, 1, D) query and contiguous (B, K, S, D) keys and values over
    the case's logical keys, with a boolean mask when not every key is
    valid; a paged case is gathered to its logical view first (not timed)."""
    if case["kind"] == "paged":
        phys = torch.clamp_min(t["table"], 0).long()
        b, pps = phys.shape
        ps = t["k"].shape[1]
        k = t["k"][phys].reshape(b, pps * ps, *t["k"].shape[2:])
        v = t["v"][phys].reshape(b, pps * ps, *t["v"].shape[2:])
        lpos = torch.arange(pps * ps, device="cuda")[None].expand(b, -1)
        kpos = torch.where(t["table"].repeat_interleave(ps, dim=1) >= 0,
                           lpos, -1)
    else:
        k, v, kpos = t["k"], t["v"], t["kpos"]
    qp = t["qpos"][:, None]
    mask = (kpos >= 0) & (kpos <= qp)
    if case["window"] is not None:
        mask &= kpos > qp - case["window"]
    q = t["q"].transpose(1, 2).contiguous()
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    attn_mask = None if bool(mask.all()) else mask[:, None, None, :]
    return q, k, v, attn_mask


def _time_case(fd, label, case, t, valid_pairs, reps) -> dict:
    b, _, h, dk = t["q"].shape
    kh, dv = t["k"].shape[2], t["v"].shape[3]
    index_ints = t["table" if case["kind"] == "paged" else "kpos"].numel()
    ms = _median_flushed(lambda: _fd_call(fd, case, t), reps)
    plain_ms = _median_flushed(lambda: _fd_call(fd, case, t, plain=True),
                               max(3, reps // 4), warmup=1)
    q, k, v, mask = _sdpa_inputs(case, t)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q, k, v, attn_mask=mask, enable_gqa=h != kh)
    # the yardstick computes the same function
    torch.testing.assert_close(library().transpose(1, 2).float(),
                               _fd_call(fd, case, t).float(),
                               atol=FD_ATOL_BF16, rtol=FD_ATOL_BF16)
    library_ms = _median_flushed(library, reps)
    bound_ms, bound_by, parts = _fd_bound(valid_pairs, kh, h // kh, dk, dv,
                                          b, index_ints, t["q"].element_size())
    log(f"  {_fd_name(case):<18} {label:<16} B={b} K={kh} G={h // kh} D={dk}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
        f"ms{' (masked)' if mask is not None else ''}; bound {bound_ms:.4f} "
        f"ms ({bound_by}: {parts['bytes'] / 1e6:.2f} MB, {valid_pairs} valid "
        f"slot-keys), {bound_ms / ms:.1%} of it, "
        f"{parts['bytes'] / ms / 1e6:.0f} GB/s")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"B": b, "K": kh, "G": h // kh, "D": dk,
                      "valid_slot_keys": valid_pairs}}


def _large_case(kind: str) -> tuple[dict, dict, int]:
    """B=64 slots x 8192 cached tokens at stablelm width in bf16 (4.3 GB of
    K/V), made on the card; every key valid."""
    c = LARGE
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, s, kh, d = c["b"], c["s"], c["kh"], c["d"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
    qpos = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
    t = {"q": randn(b, 1, kh * c["g"], d), "qpos": qpos}
    if kind == "paged":
        ps = c["page_size"]
        pps = s // ps
        perm = torch.randperm(b * pps, generator=gen, device="cuda") + 1
        t |= {"k": randn(b * pps + 1, ps, kh, d),
              "v": randn(b * pps + 1, ps, kh, d),
              "table": perm.reshape(b, pps).to(torch.int32)}
        case = {"kind": "paged", "window": None}
    else:
        t |= {"k": randn(b, s, kh, d), "v": randn(b, s, kh, d),
              "kpos": torch.arange(s, dtype=torch.int32,
                                   device="cuda").expand(b, s).contiguous()}
        case = {"kind": "dense", "window": None, "bounded": True}
    return case, t, b * s


def phase_flash_timing(fd, fdc) -> dict:
    out: dict = {}
    main = fdc.main_path_cases()
    for label in ("gemma3_1b_ring", "gemma3_1b_paged", "stablelm_dense",
                  "stablelm_paged"):
        case = main[label]
        out[label] = _time_case(fd, label, case,
                                _fd_inputs(case, torch.bfloat16),
                                fdc.valid_keys(case), reps=50)
    for kind in ("dense", "paged"):
        case, t, valid = _large_case(kind)
        out[f"large_{kind}"] = _time_case(fd, f"large_{kind}", case, t,
                                          valid, reps=10)
        del t
        torch.cuda.empty_cache()
    return out


def _texts(n: int, seed: int) -> list[dict]:
    """Request texts of 540-700 characters: words over a small alphabet."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for i in range(n):
        length = int(rng.randint(540, 701))
        words = []
        while sum(len(w) + 1 for w in words) < length:
            words.append("".join(rng.choice(letters, rng.randint(2, 10))))
        out.append({"id": f"req{i:02d}", "text": " ".join(words)[:length]})
    return out


def _serving_model(models, configs):
    cfg = configs.get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = models.init_params(models.model_spec(cfg), gen, torch.bfloat16,
                                "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers ({cfg.layer_kinds().count('local')}"
        f" local, {cfg.layer_kinds().count('attn')} global), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV head(s) "
        f"of {cfg.head_dim}, vocab {cfg.vocab_size}; {n / 1e9:.3f} B params "
        f"in bf16 drawn on the card in {time.perf_counter() - t0:.2f} s")
    return cfg, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


PROFILE_STEPS = 12


def _timed_serve(eng, sink: list, profile_at: int, trace: dict) -> None:
    """Record each device step's host time (the engine syncs right after),
    and trace PROFILE_STEPS steps from call ``profile_at`` with
    ``torch.profiler`` (their host time goes to ``trace``, not ``sink``)."""
    serve = eng._serve
    calls = [0]

    def timed(*args):
        n = calls[0]
        calls[0] += 1
        if n == profile_at:
            trace["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            trace["prof"].__enter__()
            trace["wall"] = 0.0
        t0 = time.perf_counter()
        out = serve(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if profile_at <= n < profile_at + PROFILE_STEPS:
            trace["wall"] += dt
            if n == profile_at + PROFILE_STEPS - 1:
                trace["prof"].__exit__(None, None, None)
        else:
            sink.append(dt)
        return out
    eng._serve = timed


def _device_share(trace: dict) -> dict | None:
    """Busy share of the traced steps: the union of the device kernels'
    intervals over the steps' host time, and device time by kernel."""
    prof = trace.get("prof")
    if prof is None:
        return None
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        by_name[e.name] = by_name.get(e.name, 0.0) + (end - start)
    if not spans:
        return {"busy": None}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    wall_us = trace["wall"] * 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy": busy / wall_us, "device_ms_per_step":
            busy / 1e3 / PROFILE_STEPS, "wall_ms_per_step":
            wall_us / 1e3 / PROFILE_STEPS, "kernels": len(spans) /
            PROFILE_STEPS, "top": [(n, v / 1e3 / PROFILE_STEPS)
                                   for n, v in top]}


def phase_serving(fd, cfg, params, serve, KsaCluster, ResourceProfile) -> dict:
    n_dense = cfg.layer_kinds().count("local")
    n_paged = cfg.layer_kinds().count("attn")
    eng = serve.ServeEngine(cfg, params, paged=True, page_size=64,
                            decode_kernel="flash", n_slots=8, max_len=1024,
                            device="cuda")
    eng.run_until_drained([("warm-up", [1, 2, 3, 4, 5], 2)])  # first launches
    serve.ServeRequestComputing.engine = eng
    step_s: list = []
    trace: dict = {}
    texts = _texts(N_TEXTS, seed=1)
    lens = [len(x["text"]) for x in texts]
    # trace steps late in the first generate task's prompts: the rings are
    # full and every slot holds about 9 pages
    _timed_serve(eng, step_s, profile_at=min(lens[:8]) - 2 * PROFILE_STEPS,
                 trace=trace)
    try:
        with KsaCluster(workers=1) as c:
            c.add_worker(slots=1, profile=ResourceProfile(cpus=2, gpus=1,
                                                          mem_mb=4096))
            spec = serve.serve_pipeline(batch_size=8,
                                        vocab_size=cfg.vocab_size,
                                        max_new=MAX_NEW)
            steps0 = eng.steps
            fd.flash_decode.launches = 0       # count only the main path's run
            fd.flash_decode_paged.launches = 0
            res = c.run_campaign(spec, texts, timeout_s=900.0)
            dense, paged = fd.flash_decode.launches, fd.flash_decode_paged.launches
            steps = eng.steps - steps0
            rep = c.campaign_report(res.campaign_id)
    finally:
        serve.ServeRequestComputing.engine = None
    assert res.status.state == "COMPLETED", res.status.state
    agg = res.final
    assert agg["n_requests"] == N_TEXTS, agg["n_requests"]
    assert all(r["n_tokens"] == MAX_NEW for r in agg["responses"].values())
    assert eng.allocator.used_pages == 0, eng.allocator.used_pages
    eng.allocator.check()
    assert steps > 0 and dense == n_dense * steps and paged == n_paged * steps, \
        (steps, dense, paged)
    tokens = agg["total_tokens"]
    step_ms = statistics.median(step_s[-(steps - PROFILE_STEPS):]) * 1e3
    log(f"  {N_TEXTS} requests of {min(lens)}-{max(lens)} prompt tokens, "
        f"{MAX_NEW} new tokens each: makespan {res.elapsed_s:.2f} s, "
        f"{tokens / res.elapsed_s:.2f} generated tokens/s, "
        f"{(tokens + sum(lens)) / res.elapsed_s:.1f} tokens/s with the "
        f"prompts; {steps} engine steps, median step {step_ms:.2f} ms "
        f"(host clock, synchronised)")
    for name, s in rep["stages"].items():
        log(f"    stage {name:>11}: {s['tasks']} tasks, queue "
            f"{s['queue_s']:.2f} s, run {s['run_s']:.2f} s, wall "
            f"{s['wall_s']:.2f} s")
    log(f"  launches: flash_decode {dense} = {n_dense} x {steps} steps, "
        f"flash_decode_paged {paged} = {n_paged} x {steps}; pages all "
        f"returned  ok")
    share = _device_share(trace)
    if share is None or share["busy"] is None:
        log("  torch.profiler: no device time recorded (busy share not "
            "measured)")
    else:
        log(f"  torch.profiler over {PROFILE_STEPS} steps: device busy "
            f"{share['busy']:.1%} of {share['wall_ms_per_step']:.2f} ms a "
            f"step ({share['device_ms_per_step']:.2f} ms), "
            f"{share['kernels']:.0f} kernels a step; device ms a step by "
            f"kernel:")
        for name, ms in share["top"]:
            log(f"    {ms:8.4f}  {name[:90]}")
    return {"makespan_s": res.elapsed_s, "tokens": tokens,
            "tokens_per_s": tokens / res.elapsed_s, "steps": steps,
            "step_ms": step_ms, "device": share,
            "launches": {"flash_decode": dense,
                         "flash_decode_paged": paged}}


def _greedy_with_logits(serve, cfg, params, prompts, **kw) -> tuple:
    """Greedy tokens per request, and the logits row of each generated
    token."""
    eng = serve.ServeEngine(cfg, params, n_slots=N_EXACT, max_len=1024,
                            device="cuda", **kw)
    rows: dict = {}
    inner = eng._serve

    def recording(*args):
        logits, next_ids, caches = inner(*args)
        for i, s in enumerate(eng.slots):
            if not s.done and s.position + 1 >= len(s.prompt):
                rows.setdefault(s.request_id, []).append(logits[i].cpu())
        return logits, next_ids, caches
    eng._serve = recording
    reqs = [(f"x{i}", p, MAX_NEW_EXACT) for i, p in enumerate(prompts)]
    return eng.run_until_drained(reqs), rows


def phase_exactness(cfg, params, serve) -> None:
    """float32 at full width: the dense chunked engine (the reference) and
    the flash engines must give equal greedy tokens. Near-tie rule: if the
    first difference falls where the reference's top two logits lie within
    1e-3, that step's logits must agree within 1e-3 and the request is
    compared no further."""
    cfg32 = cfg.with_(dtype="float32")
    p32 = _map(lambda x: x.float(), params)
    prompts = [[ord(ch) % cfg.vocab_size for ch in x["text"]]
               for x in _texts(N_TEXTS, seed=1)[:N_EXACT]]
    ref, ref_rows = _greedy_with_logits(serve, cfg32, p32, prompts,
                                        decode_kernel="chunked")
    for label, kw in (("dense flash", dict(decode_kernel="flash")),
                      ("paged flash", dict(decode_kernel="flash", paged=True,
                                           page_size=64))):
        got, rows = _greedy_with_logits(serve, cfg32, p32, prompts, **kw)
        worst = 0.0
        for rid, want in ref.items():
            have = got[rid]
            n = len(want)
            j = next((i for i in range(n) if have[i] != want[i]), None)
            upto = n if j is None else j
            for i in range(upto):
                worst = max(worst, float((rows[rid][i]
                                          - ref_rows[rid][i]).abs().max()))
            if j is None:
                continue
            top2 = torch.topk(ref_rows[rid][j], 2).values
            gap = float(top2[0] - top2[1])
            diff = float((rows[rid][j] - ref_rows[rid][j]).abs().max())
            assert gap <= 1e-3 and diff <= 1e-3, (label, rid, j, gap, diff)
            log(f"  near tie in {rid} at token {j}: the reference's top two "
                f"logits {gap:.3g} apart, logits within {diff:.3g}; "
                f"compared up to there")
        log(f"  {label}: greedy tokens equal to dense chunked on "
            f"{len(ref)} requests x {MAX_NEW_EXACT} tokens; max |logits - "
            f"reference| {worst:.3g}  ok")
    del p32
    torch.cuda.empty_cache()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import _flash_decode_cases as fdc
    from repro_torch import configs, models, serve
    from repro_torch.apps import knots
    from repro_torch.cluster import KsaCluster
    from repro_torch.core import ResourceProfile
    from repro_torch.kernels import build, writhe
    from repro_torch.kernels import flash_decode as fd

    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    log("== 1. environment")
    smi = phase_environment(build)
    with ThreadPoolExecutor(max_workers=2) as pool:
        log("== 2. build")
        flash_build = phase_build(build, writhe, pool)
        log("== 3. kernel against its plain version on the card")
        check_err = phase_check(knots, writhe)
        phase_parity(knots, writhe)
        log(f"== 4. timing at ({B_FULL}, {N_POINTS}, 3)")
        timing = phase_timing(knots, writhe)
        torch.cuda.empty_cache()
        log("== 5. breakdown of one batch")
        phase_breakdown(knots, writhe)
        torch.cuda.empty_cache()
        log(f"== 6. main path: KsaCluster.run_campaign, {CAMPAIGN} structures")
        launches = phase_main_path(knots, writhe, KsaCluster)
        torch.cuda.empty_cache()
        t_serve = time.perf_counter()
        log("== 7. build of the flash-decode kernels")
        phase_flash_build(fd, flash_build)
    log("== 8. flash-decode kernels against their plain versions on the card")
    fd_err = phase_flash_check(fd, fdc)
    log("== 9. flash-decode timing (median, CUDA events, L2 flushed)")
    fd_time = phase_flash_timing(fd, fdc)
    log(f"== 10. serving main path: KsaCluster.run_campaign(serve_pipeline), "
        f"{SERVE_ARCH} at full width")
    cfg, params = _serving_model(models, configs)
    served = phase_serving(fd, cfg, params, serve, KsaCluster,
                           ResourceProfile)
    log("== 11. exactness at full width in float32")
    phase_exactness(cfg, params, serve)
    t_end = time.perf_counter()
    log(f"command time: phases 1-6 {t_serve - t_start:.1f} s, phases 7-11 "
        f"{t_end - t_serve:.1f} s")

    kernels = [{
        "name": "writhe_map",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/writhe.cu",
        "replaces": "src/repro/kernels/writhe.py:97",
        "launches": launches,
        "max_abs_err": max(check_err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,   # no single PyTorch call computes a writhe map
        "shape": [B_FULL, N_POINTS, 3],
        "plain_chunk": timing["plain_chunk"],
        "plain_chunk_ms": timing["plain_chunk_ms"],
        "check": "pass",
    }]
    for name, main_shape, replaces in (
            ("flash_decode", "gemma3_1b_ring",
             "src/repro/kernels/flash_decode.py:163"),
            ("flash_decode_paged", "gemma3_1b_paged",
             "src/repro/kernels/flash_decode.py:354")):
        at = fd_time[main_shape]
        large = fd_time["large_" + ("paged" if "paged" in name else "dense")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": replaces,
            "launches": served["launches"][name],
            "max_abs_err": fd_err[name],
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            # scaled_dot_product_attention on the same valid keys (paged:
            # on the gathered logical view, the gather not timed)
            "library_ms": at["library_ms"],
            "shape": at["shape"] | {"case": main_shape},
            "max_abs_err_f32": fd_err[name + "_f32"],
            "large": large,
            "stablelm": fd_time["stablelm_" + ("paged" if "paged" in name
                                               else "dense")],
            "check": "pass",
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
