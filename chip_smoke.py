#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper GPU.

Drives the port's main path, the AlphaKnot campaign through
``repro_torch.cluster.KsaCluster.run_campaign``, at the paper's batch size
(4000 structures per task) on 512-point backbones. Before that it builds
every CUDA kernel of the path from this checkout, holds each against its
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
   sets and knot cores must be equal, and the kernel must have run.

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


def phase_build(build, writhe) -> None:
    res = build.build("writhe")
    how = f"built in {res.seconds:.2f} s" if res.seconds else "up to date"
    log(f"build writhe.cu: {how} -> {res.path.relative_to(ROOT)}")
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    writhe._library()


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
    from repro_torch.apps import knots
    from repro_torch.cluster import KsaCluster
    from repro_torch.kernels import build, writhe

    torch.cuda.set_device(0)
    log("== 1. environment")
    smi = phase_environment(build)
    log("== 2. build")
    phase_build(build, writhe)
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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
