#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper GPU.

Drives the port's main paths through ``repro_torch.cluster.KsaCluster``:
the AlphaKnot campaign at the paper's batch size (4000 structures per task)
on 512-point backbones, the serving decode path (tokenize -> generate ->
postprocess) on gemma3-1b, recurrentgemma-2b, moonshot-v1-16b-a3b and
internvl2-1b at full width, the fault-tolerant training campaigns on
mamba2-130m and on gemma3-1b at full width, one full-width layer of
deepseek-v3-671b through the serving engine, the knot campaign on a
two-site ``repro_torch.federation.FederatedCluster`` whose localize stage
runs on the remote site's GPU worker, and hubert-xlarge's encoder and
trainer and internvl2-1b's trainer at full width and depth. It builds
every CUDA kernel of those paths
from this checkout, holds each against its plain PyTorch version on the
card, and times it beside its bound. Phases:

1. environment: torch, CUDA, nvcc, the card (nvidia-smi), msgpack;
2. build: nvcc for sm_90a, with the build time and ptxas' report;
3. kernel against plain on the card, atol 6e-4 / rtol 1e-3 (the tolerance
   of tests/test_kernels.py) element by element, and within 2e-4 of the
   plain version in float64 in the Frobenius norm relative to its map's;
   the kernel's map exactly symmetric; the fused entry point's map equal to
   the kernel's and its sums (total writhe and ACN) within 3e-4 of the plain
   version's in float64, relative to the ACN, and within 1e-5 of its own
   map summed in float64; then the screen and the localization
   on the card against the same on the CPU, each knotted structure's total
   writhe within a relative 3e-4 of the plain version's in float64;
4. timing at B=4000, n=512: the map kernel, the fused map and sums
   (``writhe_and_acn``), the map kernel followed by the sums in PyTorch
   (the screen's composition before the sums were fused), the plain version
   (in the largest chunks that fit, each chunk checked against the kernel)
   and the bound; the fused entry point's map there equal to the kernel's,
   its sums held as in phase 3, chunk by chunk;
5. a breakdown of one batch's host and device work, and the peak device
   memory of ``writhe_and_acn`` beside that of the composition;
6. the main path: an 8000-structure campaign (two screen tasks of 4000),
   then the flat ``knot_batch`` baseline on the same ids; their knotted
   sets and knot cores must be equal, and the kernel must have run;
7. build of the flash-decode kernels (started beside the writhe build in
   phase 2), with the build time and ptxas' report;
8. flash-decode kernels against their plain versions on the card: the
   cases of tests/test_serve.py and the split's edges in float32 at atol
   2e-5 (empty lanes exactly zero; groups of 10 and 16 query heads on a
   KV head among them, and 7 on each of two KV heads of 64, internvl2-1b's
   group), then the serving paths' shapes in bf16 against the
   plain version in float32 on the same bf16 inputs at 2e-2; every call
   bit-identical to a second one;
9. flash-decode timing at the serving paths' shapes (gemma3-1b, stablelm
   width, recurrentgemma-2b's G = 10, moonshot-v1-16b-a3b's paged shape,
   internvl2-1b's G = 7, D = 64) and at B=64 x 8192 keys
   (stablelm width), each call queued behind a spin on the card so that
   its device time alone is timed: kernel, plain version, one
   ``scaled_dot_product_attention`` call as the yardstick, and the bound,
   with the split count and blocks launched at each; the wrapper's host
   time a call at the gemma3-1b shapes (1000 calls, host clock, no sync);
10. the serving main path: gemma3-1b at full width in bf16 (random weights
   from ``init_params``), its depth cut to its first period and its tail
   (8 of 26 layers), a paged flash ``ServeEngine`` behind
   ``serve_pipeline``: 16 requests in two generate tasks answered with 16
   tokens each, every page returned, and exactly 7 dense and 1 paged
   kernel launches per step;
11. exactness at full width in float32 on the same 8 layers (local and
   global, so both decode kernels): dense chunked (the reference), dense
   flash and paged flash engines give the same greedy tokens;
12. build of the SSD-scan kernels (started beside the others in phase 2);
13. the SSD-scan kernels against their plain versions on the card. The
   forward: the cases of tests/test_kernels.py (f32 atol 1e-4, bf16 5e-2),
   initial and final states, ragged lengths, a chunk that overflows the
   unmasked exponent, the training shape in bf16 against the plain version
   in float32 (5e-2) and twice bit-identical. The backward kernel against
   ``ssd_scan_bwd_plain``: the same cases in float32 (1e-4, against the
   plain version in float64 on the same inputs; all outputs finite), with
   either cotangent absent, the training shape in bf16 against the plain
   version in float32 by relative norm error per output, and twice
   bit-identical; the autograd function's gradients against autograd
   through the plain version in float64 (1e-4), one backward launch each;
14. SSD-scan timing at the training shape (8 x 2048, 24 heads of 64, N 128,
   bf16): forward and backward kernels, their plain versions and bounds
   (no PyTorch call computes the scan), and each by kernel;
15. the training main path: mamba2-130m at full width, bf16 params with an
   fp32 master, batch 8 x 2048, a ``TrainCampaign`` of 16 steps in 2 chunks
   of 8 on a GPU worker of ``KsaCluster``: exactly 24 forward and 24
   backward SSD launches per step, no call of a plain version on a CUDA
   tensor, finite losses, a checkpoint at step 16, the memory resident at
   every step of chunk 2 within 1% of chunk 1's last; step time,
   tokens/s, checkpoint save and restore times and sizes, device memory.
   Then the step apart, as phase 21's (3 steps, the same counts, device
   busy share and device ms a step by kernel);
16. recovery at full width: 8 steps in 2 chunks of 4 with the agent crashed
   in chunk 2; the watchdog resubmits; 24 forward and 24 backward SSD
   launches for every step run and no plain-version call on a CUDA tensor;
   the step-8 checkpoint must equal phase 15's bit for bit (else the ops
   that vary are named);
17. one train step at full width cut to 2 layers in float32 on the card
   (through both SSD kernels) and on the CPU: loss, grad norm and updated
   params agree;
18. build of the flash-attention kernel (started beside the others in
   phase 2);
19. the flash-attention kernels against their plain versions on the card:
   the cases of tests/test_kernels.py (forward f32 atol/rtol 2e-5, bf16
   2e-2; the log-sum-exp 1e-5; the backward's dq, dk, dv f32 1e-5, bf16
   against the plain version in float32 2e-2), the bidirectional case,
   points of the property sweep, q_offset > 0, rows with no valid key
   (exact zeros, lse -inf, zero dq), the model shapes (gemma3-1b global
   and local, stablelm-1.6b, hubert-xlarge, internvl2-1b) in float32
   against the plain versions in float32 (the backward against float64
   autograd, 4e-5) and in bf16 against them (the backward also by its
   relative norm error, 5e-3 a tensor), twice bit-identical forward and backward,
   hubert-xlarge's bidirectional shape at S = 32768 (B = 1, the forward
   and its log-sum-exp in bf16 against the plain versions in float32 on
   every row, the output also by its relative norm error, 5e-3, twice
   bit-identical), and
   the autograd function's gradients against autograd through the plain
   version (1e-5), one backward launch each;
20. flash-attention timing at the gemma3-1b global and local shapes of the
   main path and the stablelm-1.6b shape (B=2, S=4096), bf16: the forward
   kernel, its earlier fp32 FMA design, the plain version,
   ``scaled_dot_product_attention`` as the yardstick and the bound; the
   backward kernel, its plain version, SDPA's backward and its bound;
21. the attention training main path: gemma3-1b at full width cut to one
   5:1 period (6 layers: 5 local, 1 global), bf16 params with an fp32
   master, batch 2 x 4096, a ``TrainCampaign`` of 8 steps in 2 chunks of
   4 on a GPU worker, the second restoring the first's checkpoint: exactly
   6 forward and 6 backward flash-attention launches per step, no call of
   a plain version on a CUDA tensor and no SSD launch, finite losses, a
   checkpoint at step 8, the memory resident at every step of chunk 2
   within 1% of chunk 1's last; step time, tokens/s, checkpoint save and
   restore, device memory (held before the campaign, resident at each
   step's start, peak). Then the full 26-layer step apart: 3
   ``make_train_step`` steps after a warm-up, exactly 26 + 26 launches a
   step, no plain version; the median step, tokens/s, peak memory, the
   operations bound, device ms and kernels a step;
22. one train step of gemma3-1b at full width cut to 2 layers (one local,
   one global) in float32 on the card and on the CPU, through both
   kernels: loss, grad norm and updated params agree;
23. recurrentgemma-2b at full width in bf16 served through
   ``serve_pipeline``: 8 requests of 96-160 prompt tokens, 16 new tokens
   each, one generate task, 8 slots, max_len 4096 (2048-row rings): exactly
   8 dense flash-decode launches (G = 10) and no paged one a step, no
   plain attention on the card; makespan, tokens/s, median step, device
   busy, device ms a step by kernel, peak memory, the weights bound;
24. recurrentgemma-2b at full width in float32: the dense (max_len 4096)
   and paged (max_len 1024) flash engines' greedy tokens equal the chunked
   engine's; the dense flash engine's decode logits against the
   whole-sequence forward (the RG-LRU scan, flash attention at G = 10,
   window 2048) on the same tokens, relative 2e-4;
25. moonshot-v1-16b-a3b at full width (64 experts) cut to 24 of its 48
   layers in bf16, served as in 23 but paged (max_len 1024, pages of 64):
   exactly 24 paged launches and no dense one a step, beside the weights
   bound of a dropless step; then at full width cut to 8 layers in
   float32: the paged
   flash engine's tokens equal the chunked engine's, and ``moe_capacity``
   (dropless) equals ``moe_ref`` on one layer's experts (relative 1e-5);
26. deepseek-v3-671b at full width cut to one layer (MLA, 256 experts): 4
   requests through the dense engine in bf16 (a paged engine raises, as in
   the reference), the step beside the weights bound; in float32 the
   absorbed decode's logits against the materialized whole-sequence
   forward's (the MoE there dropless too), relative 2e-4;
27. the knot campaign of phase 6 on a ``FederatedCluster``: home site
   ``edge`` (CPU workers), remote site ``hpc`` (CPU workers and one GPU
   worker) behind a ``WanLink`` of 10 ms and 500 Mbit/s, the localize
   stage pinned to ``hpc`` and its GPU class, the screen spilling on
   backlog: processed, kept, knotted and cores equal to phase 6's, every
   localize task completed at home by a ``bridge-hpc-`` relay and done in
   the ``hpc`` monitor on its GPU worker, writhe launches at least the
   tasks with work, site-labelled metrics of both sites; the makespan,
   each stage's queue, run and wall seconds, the tasks each bridge
   relayed, and the completed leases by site;
28. hubert-xlarge at full width and depth (48 bidirectional layers, D =
   80) in bf16: three ``make_prefill_step`` calls on 1 x 32768 frames
   (exactly 48 flash-attention launches a call, no plain version on the
   card, finite logits) beside the operations bound; then three train
   steps at 2 x 4096 frames (48 + 48 launches a step) and one float32
   step at full width cut to 2 layers on the card and on the CPU;
29. internvl2-1b at full width and depth (24 layers, 14 heads on 2 KV
   heads of 64: G = 7) in bf16 served as in 23 (exactly 24 dense
   flash-decode launches and no paged one a step) beside the weights
   bound; at full width cut to 4 layers in float32 the dense and paged
   flash engines' tokens equal the chunked engine's; three train steps
   at 2 x 4096 text tokens and 256 patches (24 + 24 launches a step) and
   the float32 2-layer step on the card and on the CPU;
30. remat: phase 21's 26-layer gemma3-1b step and phase 15's mamba2-130m
   step again under ``remat="full"`` (each period checkpointed, the tail
   not): 50 forward and 26 backward flash-attention launches a gemma3
   step (2 x 24 + 2), 48 forward and 24 backward SSD launches a mamba2
   step, asserted; median, peak, held memory and kernels a step beside
   the steps without; then gemma3-1b at full width cut to one period (6
   layers) in float32, one step under each policy ("full", "dots",
   "dots_no_batch") against the step without: loss and params within
   1e-5, and whether bit-equal;
31. the sharded train step on a world of one process (NCCL from an
   in-memory store, a (data=1, model=1) ``DeviceMesh``): in float32,
   mamba2-130m at full width and depth (the SSD kernels inside the
   blocks' ``local_map`` regions) and moonshot-v1-16b-a3b at full width
   cut to one layer, 2 x 512 (the MoE and vocab-parallel islands), the
   sharded step against the unsharded one from the same state: loss and
   params within 1e-5, every kernel launched once a layer each way, no
   plain version on the card; then three bf16 mamba2-130m steps at 8 x
   2048 sharded beside three unsharded (DTensor's host overhead), every
   sharded loss within 1e-5 relative of the unsharded one and the params
   after the last step compared.

The last four lines of its output are the families line (JSON: phases
21, 23-31), the kernels line (JSON), the card's name and power limit as
nvidia-smi gives them, and the result line (JSON).
It exits non-zero, and prints no result, when CUDA is unavailable, when the
repository's sources are missing, or when any phase fails. Every cluster
runs with a 600 s session (phase 16's with 10 s, so that its crashed agent
is evicted), each serving and knot campaign with a 300 s timeout, and past
1140 s the script writes every thread's stack to stderr and exits.

Run from the root of a checkout:  python3 chip_smoke.py

``python3 chip_smoke.py --against DIR`` runs none of the phases: it sets
the writhe map and ``writhe_and_acn`` (DIR's: its map kernel, then the sums
in PyTorch) and the flash-decode wrappers of this checkout beside those of
the checkout at DIR (the parent commit, unpacked with ``git archive``) in
one process: the writhe calls' device time at phase 4's shape in
alternating pairs, the decode wrappers' host time a call in alternating
pairs and device time at phase 9's shapes that both checkouts take, in
alternating pairs. It prints the readings as one JSON line, then the card's
name and power limit.
``python3 chip_smoke.py --train-against DIR`` likewise runs phase 15's
mamba2-130m train step (full width, 8 x 2048 tokens, no campaign) of DIR
and of this checkout, each in a process of its own, in the order DIR,
this, this, DIR: the median step, tokens/s, device ms and kernels a step,
and the device memory held and at peak.
"""
from __future__ import annotations

import contextlib
import faulthandler
import filecmp
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the gemma3-1b campaign (phase 21) peaks within a few GB of the card's
# memory: growable segments keep what the allocator reserves close to what
# it hands out (read when CUDA first allocates, so set before torch loads)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
# The broker evicts a group member whose loop thread has not heartbeat for
# its session (10 s by default); an evicted agent is fenced for good, and
# the campaign it served waits out its timeout. A host stall, the GIL held
# by a task thread, or a step of the wall clock (the broker ages
# heartbeats by time.time()) can outlast 10 s, so every cluster here runs
# with this session, but phase 16's, whose crashed agent must be evicted.
SESSION_TIMEOUT_S = 600.0
# a campaign of phases 6, 10, 23, 25, 27 and 29 takes about a minute at
# most: one that stalls fails in this time, well inside the script's limit
CAMPAIGN_TIMEOUT_S = 300.0
# the whole script must end within 1200 s: past this, every thread's stack
# goes to stderr and the process exits with a code other than 0
WATCHDOG_S = 1140.0
# H100 SXM, NVIDIA data sheet: HBM3 bytes/s and fp32 (non-tensor) FLOP/s
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# fp32 operations the function needs per off-band segment pair, whatever
# the kernel's way of computing them (an FMA is two, a transcendental one):
# differences 12, cross products 4x9, the normals' squared norms 4x5, +eps
# 4, reciprocal square roots 4, the normals' dots as dot(c_k, c_k+1) times
# both inverse norms 4x7, clips 4x2, asins 4, their sum 3, the sign's two
# differences 6, cross 9, dot 5 and 2 compares, the scale 2
OPS_PER_PAIR = 12 + 36 + 20 + 4 + 4 + 28 + 8 + 4 + 3 + 6 + 9 + 5 + 2 + 2


T_START = time.perf_counter()


def log(*args) -> None:
    """print, flushed; a phase's heading (``== n. ...``) gains the seconds
    since the script started."""
    if args and str(args[0]).startswith("== "):
        args = (*args, f"[{time.perf_counter() - T_START:.1f} s]")
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
    try:
        import zstandard
        log("zstandard: imports, version", zstandard.__version__,
            "(checkpoint shards in zstd)")
    except ImportError:
        log("zstandard: not installed (checkpoint shards in zlib)")
    mem = next((line.split(":", 1)[1].strip()
                for line in Path("/proc/meminfo").read_text().splitlines()
                if line.startswith("MemTotal:")), "not read")
    log(f"host: {os.cpu_count()} CPUs, MemTotal {mem}")
    return smi


def report_build(name: str, res) -> None:
    """The build's time and, per kernel (its mangled name), ptxas'
    registers and spills."""
    how = f"built in {res.seconds:.2f} s" if res.seconds else "up to date"
    log(f"build {name}.cu: {how} -> {res.path.relative_to(ROOT)}")
    for line in res.log.splitlines():
        if "Compiling entry function" in line:
            log("  ptxas:", line.split("'")[1])
        elif "registers" in line or "spill" in line:
            log("    ", line.replace("ptxas info    :", "").strip())


def phase_build(build, writhe, pool) -> dict:
    """Every source compiles at once, one nvcc each; the writhe build is
    reported here, the flash-decode one in phase 7, the SSD one in phase
    12, the flash-attention one in phase 18."""
    pending = {name: pool.submit(build.build, name)
               for name in ("writhe", "flash_decode", "ssd",
                            "flash_attention")}
    report_build("writhe", pending["writhe"].result())
    writhe._library()
    return pending


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
    sums = check_sums(writhe, name, x, got)
    log(f"  {name:<24} {tuple(coords.shape)}: max |kernel - plain| "
        f"{err:.3g}; against fp64, ||.||_F relative: kernel {rel:.3g}, "
        f"plain fp32 {rel_plain:.3g}; entries under ATOL hold {share:.3g} "
        f"of ||W||_F; max |W - W^T| {asym:.3g}; {sums}  ok")
    return err


def sums_errors(writhe, x: torch.Tensor, w: torch.Tensor, wr: torch.Tensor,
                acn: torch.Tensor) -> tuple[float, float, float, torch.Tensor]:
    """The fused entry point's sums ``wr``, ``acn`` on ``x``, whose map is
    ``w``: their largest errors against the plain version's in float64,
    relative to its ACN (a random walk's writhe may cancel to ~0; the ACN
    sums the magnitudes whose round-off the writhe collects), wr's then
    acn's; the larger of both against ``w`` summed in float64, relative to
    that ACN; and that ACN, (B,) float64."""
    tiny = torch.finfo(torch.float64).tiny
    ewr, eacn, _ = writhe.writhe_sums_ref(x.double())
    scale = eacn.clamp_min(tiny)
    rel_wr = float(((wr.double() - ewr).abs() / scale).max())
    rel_acn = float(((acn.double() - eacn).abs() / scale).max())
    del ewr, eacn
    own = w.double()
    own_wr = own.sum(dim=(1, 2)) / 2
    own_acn = own.abs().sum(dim=(1, 2)) / 2
    sum_err = float(torch.maximum((wr.double() - own_wr).abs(),
                                  (acn.double() - own_acn).abs()).div(
                                      own_acn.clamp_min(tiny)).max())
    return rel_wr, rel_acn, sum_err, own_acn


def check_sums(writhe, name: str, x: torch.Tensor, w: torch.Tensor) -> str:
    """The fused entry point on ``x``: its map equal to the map kernel's
    ``w``; its total writhe and ACN within WR_REL of the plain version's in
    float64, relative to the ACN; and its sums against its own map's summed
    in float64: each within 1e-5 of the ACN, the mean ACN within 1e-5. (The
    mean ACN is held to the plain version's in float32 by phase 3's parity,
    on the screen's batches.)"""
    wr, acn, fused = writhe.writhe_map_sums(x)
    torch.cuda.synchronize()
    assert torch.equal(fused, w), (name, "fused map differs")
    if not x.shape[0]:
        return "sums: none (B=0)"
    rel_wr, rel_acn, sum_err, own_acn = sums_errors(writhe, x, w, wr, acn)
    assert rel_wr <= WR_REL and rel_acn <= WR_REL, (name, rel_wr, rel_acn)
    mean, own_mean = float(acn.double().mean()), float(own_acn.mean())
    assert sum_err <= 1e-5, (name, sum_err)
    assert abs(mean - own_mean) <= 1e-5 * abs(own_mean), (name, mean, own_mean)
    return (f"fused sums against fp64, relative to the ACN: wr {rel_wr:.3g}, "
            f"acn {rel_acn:.3g}; against its own map summed in fp64 "
            f"{sum_err:.3g}")


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
            f"CPU {wr_cpu:.3g}; mean ACN card against CPU "
            f"{(gpu[3] - cpu[3]) / cpu[3]:.3g} relative  ok")


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
    # the screen's entry point at the same shape: its map must be the map
    # kernel's bit for bit (held to the plain version below, chunk by
    # chunk), and its sums are held beside it
    wr, acn, fused = knots.writhe_and_acn(x)
    torch.cuda.synchronize()
    assert torch.equal(fused, out), "writhe_and_acn's map differs"
    del fused
    bound_ms, bound_by, parts = bound(B_FULL, N_POINTS)
    log(f"  bound {bound_ms:.3f} ms ({bound_by}: {parts['ops']:.4g} fp32 "
        f"ops -> {parts['ops_ms']:.3f} ms, {parts['bytes']:.4g} bytes -> "
        f"{parts['bytes_ms']:.3f} ms)")
    calls = {"kernel": lambda: writhe.writhe_map(x),
             "writhe_and_acn": lambda: knots.writhe_and_acn(x),
             "composition": lambda: composed_sums(writhe.writhe_map, x)}
    times = {}
    for label, fn in calls.items():
        times[label] = median_ms(fn, reps=10)
        ms = times[label]
        log(f"  {label} ({B_FULL}, {N_POINTS}, 3): median {ms:.3f} ms over "
            f"10; {bound_ms / ms:.1%} of the bound, "
            f"{parts['ops'] / ms / 1e9:.1f} TFLOP/s, "
            f"{parts['bytes'] / ms / 1e6:.0f} GB/s")
    ms = times["kernel"]
    log(f"  writhe_and_acn / kernel {times['writhe_and_acn'] / ms:.3f}, "
        f"composition / kernel {times['composition'] / ms:.3f}")

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
    rel_wr = rel_acn = sum_err = 0.0
    own_acn = []
    half = max(chunk // 2, 1)      # the float64 plain version: twice the bytes
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
        for h in range(s, min(s + chunk, B_FULL), half):
            e = sums_errors(writhe, x[h:h + half], out[h:h + half],
                            wr[h:h + half], acn[h:h + half])
            rel_wr, rel_acn = max(rel_wr, e[0]), max(rel_acn, e[1])
            sum_err = max(sum_err, e[2])
            own_acn.append(e[3])
    assert torch.equal(out, out.transpose(1, 2)), "kernel map not symmetric"
    assert rel_wr <= WR_REL and rel_acn <= WR_REL, (rel_wr, rel_acn)
    assert sum_err <= 1e-5, sum_err
    mean, own_mean = float(acn.double().mean()), float(torch.cat(own_acn).mean())
    assert abs(mean - own_mean) <= 1e-5 * abs(own_mean), (mean, own_mean)
    log(f"  plain ({chunk}, {N_POINTS}, 3): median {one_ms:.3f} ms over 3; "
        f"all {B_FULL} in chunks: {plain_ms:.3f} ms; full-size check: max "
        f"|kernel - plain| {err:.3g}  ok")
    log(f"  writhe_and_acn ({B_FULL}, {N_POINTS}, 3): map == the map "
        f"kernel's; sums against the plain version in fp64, relative to the "
        f"ACN: wr {rel_wr:.3g}, acn {rel_acn:.3g}; against its own map "
        f"summed in fp64 {sum_err:.3g}; mean ACN "
        f"{(mean - own_mean) / own_mean:.3g} relative  ok")
    return {"ms": ms, "plain_ms": plain_ms, "plain_chunk": chunk,
            "plain_chunk_ms": one_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err,
            "fused_ms": times["writhe_and_acn"],
            "composition_ms": times["composition"]}


def composed_sums(writhe_map, x: torch.Tensor) -> tuple:
    """The screen's sums as they were before the kernel fused them: the map
    kernel, then ``W.sum() / 2`` and ``|W|.sum() / 2`` in PyTorch."""
    w = writhe_map(x)
    return (w.sum(dim=(1, 2)) / 2.0, torch.abs(w).sum(dim=(1, 2)) / 2.0, w)


def peak_bytes(fn) -> int:
    """Device memory ``fn`` allocates at its peak, above what was held."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def phase_breakdown(knots, writhe) -> dict:
    """Where one screen + localize batch spends its time, piece by piece;
    then the peak device memory of ``writhe_and_acn`` and of the
    composition it replaced, on the same batch."""
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
    del wr, acn, w, block
    peaks = {"writhe_and_acn": peak_bytes(lambda: knots.writhe_and_acn(x)),
             "composition": peak_bytes(
                 lambda: composed_sums(writhe.writhe_map, x))}
    map_bytes = B_FULL * (N_POINTS - 1) ** 2 * 4
    log(f"  peak device memory above the coordinates: writhe_and_acn "
        f"{peaks['writhe_and_acn'] / 1e9:.3f} GB, the composition "
        f"{peaks['composition'] / 1e9:.3f} GB (one map: "
        f"{map_bytes / 1e9:.3f} GB)")
    return peaks


def phase_main_path(knots, writhe, KsaCluster) -> dict:
    ids = list(range(CAMPAIGN))
    writhe.writhe_map.launches = 0         # count only the main path's run
    with KsaCluster(workers=1, gpu_workers=1,
                    session_timeout_s=SESSION_TIMEOUT_S) as c:
        spec = knots.knots_pipeline(B_FULL, n_points=N_POINTS,
                                    gpu_localize=True)
        res = c.run_campaign(spec, ids, timeout_s=CAMPAIGN_TIMEOUT_S)
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
        assert c.wait_all(tids, timeout=CAMPAIGN_TIMEOUT_S), \
            "flat baseline stalled"
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
    return {"launches": launches, "final": agg, "elapsed_s": res.elapsed_s}


# -- the serving decode path (phases 7-11) ------------------------------------

FD_ATOL_F32, FD_ATOL_BF16 = 2e-5, 2e-2     # tests/test_serve.py, test_kernels
SERVE_ARCH = "gemma3_1b"
# 16 requests make two generate tasks of the pipeline's batch of 8: the
# second reuses the slots and pages the first returned
N_TEXTS, MAX_NEW, N_EXACT, MAX_NEW_EXACT = 16, 16, 4, 8
# phase 10's depth: gemma3-1b's first 5:1 period and its two tail layers
# (of 26: its host-bound step scales with the layers it runs), so both
# decode kernels; phase 11 checks the same 8 layers
SERVE_LAYERS = 8
EXACT_SERVE_LAYERS = 8
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
        again = _fd_call(fd, case, t)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (name, "not bit-identical")
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
            f"{e:.3g}, empty lanes {list(case['empty'])} exactly 0, "
            f"bit-identical twice  ok")
    for name, case in fdc.main_path_cases().items():
        t = _fd_inputs(case, torch.bfloat16)
        got = _fd_call(fd, case, t)
        again = _fd_call(fd, case, t)
        torch.cuda.synchronize()
        assert torch.equal(got, again), (name, "not bit-identical")
        t32 = dict(t, q=t["q"].float(), k=t["k"].float(), v=t["v"].float())
        want = _fd_call(fd, case, t32, plain=True)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, atol=FD_ATOL_BF16,
                                   rtol=FD_ATOL_BF16)
        e = float((got.float() - want).abs().max())
        err[_fd_name(case)] = max(err[_fd_name(case)], e)
        log(f"  bf16 {name:<21} {_fd_name(case):<18} q {tuple(case['q'].shape)}"
            f" k {tuple(case['k'].shape)}: max |kernel - plain fp32| {e:.3g}"
            f", bit-identical twice  ok")
    return {k: max(err[k], err_f32[k]) for k in err} | {
        f"{k}_f32": v for k, v in err_f32.items()}


# about half a millisecond of spinning, longer than a wrapper's host time
QUEUE_CYCLES = 1_000_000


def _median_flushed(fn, reps: int, warmup: int = 2,
                    queued: bool = False) -> float:
    """Median device time of ``fn`` (CUDA events), the L2 cache flushed
    before each timed run, as a decode step finds it after other layers.
    With ``queued`` the card spins after the flush (``torch.cuda._sleep``)
    while the host enqueues the call, so a call whose device time is shorter
    than its host time is timed on the device alone, without the host's
    launch time between the events."""
    scratch = torch.empty(L2_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scratch.zero_()
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
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


HOST_CALLS, HOST_BATCH = 1000, 100


def host_us(fn) -> float:
    """The host's time a call of ``fn``: HOST_CALLS calls on the host clock
    in batches of HOST_BATCH, no sync inside a batch; the card drains
    between batches (not timed), so the launch queue never fills. The median
    of the batches' means, as the host's clock is shared."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(HOST_CALLS // HOST_BATCH):
        t0 = time.perf_counter()
        for _ in range(HOST_BATCH):
            fn()
        per_call.append((time.perf_counter() - t0) / HOST_BATCH)
        torch.cuda.synchronize()
    return statistics.median(per_call) * 1e6


def _time_case(fd, label, case, t, valid_pairs, reps) -> dict:
    b, _, h, dk = t["q"].shape
    kh, dv = t["k"].shape[2], t["v"].shape[3]
    index_ints = t["table" if case["kind"] == "paged" else "kpos"].numel()
    ms = _median_flushed(lambda: _fd_call(fd, case, t), reps, queued=True)
    # the plan the wrapper gave the kernel in the timed calls
    n_split, _, grid = getattr(fd, _fd_name(case)).last_plan
    blocks = math.prod(grid)
    plain_ms = _median_flushed(lambda: _fd_call(fd, case, t, plain=True),
                               max(3, reps // 4), warmup=1, queued=True)
    q, k, v, mask = _sdpa_inputs(case, t)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q, k, v, attn_mask=mask, enable_gqa=h != kh)
    # the yardstick computes the same function
    torch.testing.assert_close(library().transpose(1, 2).float(),
                               _fd_call(fd, case, t).float(),
                               atol=FD_ATOL_BF16, rtol=FD_ATOL_BF16)
    library_ms = _median_flushed(library, reps, queued=True)
    bound_ms, bound_by, parts = _fd_bound(valid_pairs, kh, h // kh, dk, dv,
                                          b, index_ints, t["q"].element_size())
    log(f"  {_fd_name(case):<18} {label:<16} B={b} K={kh} G={h // kh} D={dk}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} "
        f"ms{' (masked)' if mask is not None else ''}; bound {bound_ms:.4f} "
        f"ms ({bound_by}: {parts['bytes'] / 1e6:.2f} MB, {valid_pairs} valid "
        f"slot-keys), {bound_ms / ms:.1%} of it, "
        f"{parts['bytes'] / ms / 1e6:.0f} GB/s; {n_split} split(s), "
        f"{blocks} blocks")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "n_split": n_split, "blocks": blocks,
            "shape": {"B": b, "K": kh, "G": h // kh, "D": dk,
                      "valid_slot_keys": valid_pairs}}


def _large_case(fdc, kind: str) -> tuple[dict, dict, int]:
    """B=64 slots x 8192 cached tokens at stablelm width in bf16 (4.3 GB of
    K/V), made on the card; every key valid."""
    c = fdc.LARGE_SHAPE
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
    for label in fdc.MAIN_PATH:
        case = main[label]
        out[label] = _time_case(fd, label, case,
                                _fd_inputs(case, torch.bfloat16),
                                fdc.valid_keys(case), reps=50)
    for label in ("gemma3_1b_ring", "gemma3_1b_paged"):
        case = main[label]
        t = _fd_inputs(case, torch.bfloat16)
        out[label]["host_us"] = us = host_us(lambda: _fd_call(fd, case, t))
        log(f"  {_fd_name(case):<18} {label:<16} host time a call "
            f"{us:.2f} us ({HOST_CALLS} calls, host clock, no sync)")
    for kind in ("dense", "paged"):
        case, t, valid = _large_case(fdc, kind)
        out[f"large_{kind}"] = _time_case(fd, f"large_{kind}", case, t,
                                          valid, reps=10)
        del t
        torch.cuda.empty_cache()
    return out


# -- against another checkout ------------------------------------------------

AGAINST_PAIRS = 20


def _load_against(other: Path):
    """``build``, ``kernels.flash_decode`` and ``kernels.writhe`` of the
    checkout at ``other``, imported under another package name beside this
    tree's (its libraries build under ``other/build``)."""
    import importlib
    import importlib.util
    name = "_against_repro_torch"
    pkg = other.resolve() / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{name}.kernels.build"),
            importlib.import_module(f"{name}.kernels.flash_decode"),
            importlib.import_module(f"{name}.kernels.writhe"))


def compare_writhe(other_writhe, writhe, knots) -> dict:
    """The writhe map kernel and ``writhe_and_acn`` of this tree beside the
    other tree's map kernel and its map kernel followed by the sums in
    PyTorch (``writhe_and_acn`` before the sums were fused), at phase 4's
    shape: the median of 5 calls (CUDA events) in AGAINST_PAIRS pairs that
    alternate which tree runs first."""
    coords, _ = knots.synthesize_batch(range(B_FULL), N_POINTS)
    x = torch.from_numpy(coords).cuda()
    calls = {
        "writhe_map": {"this": lambda: writhe.writhe_map(x),
                       "other": lambda: other_writhe.writhe_map(x)},
        "writhe_and_acn": {
            "this": lambda: knots.writhe_and_acn(x),
            "other": lambda: composed_sums(other_writhe.writhe_map, x)}}
    out: dict = {"shape": [B_FULL, N_POINTS, 3]}
    for label, sides in calls.items():
        reads: dict = {"this": [], "other": []}
        for i in range(AGAINST_PAIRS):
            for side in (("other", "this") if i % 2 == 0
                         else ("this", "other")):
                reads[side].append(median_ms(sides[side], reps=5))
        ratio = [a / b for a, b in zip(reads["this"], reads["other"])]
        out[label] = {"this": _spread(reads["this"]),
                      "other": _spread(reads["other"]),
                      "this_over_other": _spread(ratio), "readings": reads}
        for side in ("this", "other", "this_over_other"):
            sp = out[label][side]
            unit = "" if side == "this_over_other" else " ms"
            log(f"  {label:<15} {side:<16} median {sp['median']:.4f}{unit}, "
                f"quartiles {sp['q1']:.4f}-{sp['q3']:.4f}, range "
                f"{sp['min']:.4f}-{sp['max']:.4f}")
    return out


def _spread(xs: list[float]) -> dict:
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q1, "q3": q3,
            "min": min(xs), "max": max(xs)}


def compare_against(other: Path, fd, build, fdc, writhe, knots,
                    smi: str) -> dict:
    """This tree's writhe calls (:func:`compare_writhe`) and flash-decode
    wrappers beside the checkout at ``other``'s (its parent, say), in one
    process on one card. Host time a call
    (:func:`host_us`) at the gemma3-1b shapes in AGAINST_PAIRS pairs that
    alternate which tree runs first, with each side's spread and that of
    the paired differences; then device time at the phase-9 shapes that
    both trees take (a tree whose kernels stop at G = 8 skips
    recurrentgemma-2b's), in AGAINST_PAIRS // 2 pairs of medians that
    alternate which tree runs first, queued as phase 9 times it and
    unqueued (the host's launch time inside the events, as phase 9 timed
    before it queued), with each side's spread and that of the ratios."""
    other_build, other_fd, other_writhe = _load_against(other)
    with ThreadPoolExecutor(max_workers=4) as pool:
        built = list(pool.map(lambda bn: (bn[0].build(bn[1]), bn[1]),
                              [(b, n) for n in ("writhe", "flash_decode")
                               for b in (build, other_build)]))
    for side, (res, src) in zip(("this", "other") * 2, built):
        log(f"build {src}.cu ({side}): {res.seconds:.2f} s -> {res.path}")
    out: dict = {"against": str(other), "card": smi, "pairs": AGAINST_PAIRS,
                 "host_us": {}, "device_ms": {}}
    log(f"== writhe at ({B_FULL}, {N_POINTS}, 3), device ms, "
        f"{AGAINST_PAIRS} alternating pairs ({smi})")
    out["writhe"] = compare_writhe(other_writhe, writhe, knots)
    torch.cuda.empty_cache()
    trees = {"this": fd, "other": other_fd}
    main = fdc.main_path_cases()
    log(f"== host time a call, {AGAINST_PAIRS} alternating pairs ({smi})")
    for label in ("gemma3_1b_ring", "gemma3_1b_paged"):
        case = main[label]
        t = _fd_inputs(case, torch.bfloat16)
        for side in trees:          # build, load and warm both
            _fd_call(trees[side], case, t)
        reads: dict = {"this": [], "other": []}
        for i in range(AGAINST_PAIRS):
            for side in (("other", "this") if i % 2 == 0
                         else ("this", "other")):
                reads[side].append(
                    host_us(lambda: _fd_call(trees[side], case, t)))
        diff = [a - b for a, b in zip(reads["this"], reads["other"])]
        out["host_us"][label] = {
            "this": _spread(reads["this"]), "other": _spread(reads["other"]),
            "this_minus_other": _spread(diff), "readings": reads}
        for side in ("this", "other", "this_minus_other"):
            sp = out["host_us"][label][side]
            log(f"  {label:<16} {side:<16} median {sp['median']:.2f} us, "
                f"quartiles {sp['q1']:.2f}-{sp['q3']:.2f}, range "
                f"{sp['min']:.2f}-{sp['max']:.2f}")
    log(f"== device time a call, {AGAINST_PAIRS // 2} alternating pairs of "
        f"medians")
    shapes = [(label, main[label], None) for label in fdc.MAIN_PATH
              if main[label]["q"].shape[2] // main[label]["k"].shape[2]
              <= other_fd.MAX_G]
    shapes += [(f"large_{kind}", None, kind) for kind in ("dense", "paged")]
    for label, case, large in shapes:
        if large:
            case, t, _ = _large_case(fdc, large)
            reps = 10
        else:
            t = _fd_inputs(case, torch.bfloat16)
            reps = 50
        out["device_ms"][label] = {}
        for queued in (True, False):
            reads: dict = {"this": [], "other": []}
            for i in range(AGAINST_PAIRS // 2):
                for side in (("other", "this") if i % 2 == 0
                             else ("this", "other")):
                    reads[side].append(_median_flushed(
                        lambda: _fd_call(trees[side], case, t), reps,
                        queued=queued))
            ratio = [a / b for a, b in zip(reads["this"], reads["other"])]
            how = "queued" if queued else "unqueued"
            out["device_ms"][label][how] = {
                "this": _spread(reads["this"]),
                "other": _spread(reads["other"]),
                "this_over_other": _spread(ratio), "readings": reads}
            r = out["device_ms"][label][how]["this_over_other"]
            log(f"  {label:<23} {how:<8} other "
                f"{statistics.median(reads['other']):.4f} ms, this "
                f"{statistics.median(reads['this']):.4f} ms; this / other "
                f"median {r['median']:.4f}, range {r['min']:.4f}-"
                f"{r['max']:.4f}")
        del t
        torch.cuda.empty_cache()
    return out


TRAIN_AGAINST_STEPS = 12         # the first two warm up


def train_step_reading(tree: Path) -> dict:
    """The mamba2-130m train step at phase 15's width and batch, with the
    ``repro_torch`` of the checkout at ``tree``: the median of
    TRAIN_AGAINST_STEPS - 2 steps (host clock, synchronised), the device
    memory held before them and the peak during them, then device ms and
    kernels a step over PROFILE_TRAIN_STEPS steps (torch.profiler)."""
    sys.path.insert(0, str(tree.resolve() / "src"))
    from repro_torch import configs, data
    from repro_torch.train import step as step_mod
    from repro_torch.train import trainer
    cfg = configs.get_config(TRAIN_ARCH)
    ocfg = trainer._ocfg_from_params({})
    state = step_mod.init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = step_mod.make_train_step(cfg, ocfg)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(
        cfg, 0, s, batch=TRAIN["batch"], seq=TRAIN["seq"]).items()}
        for s in range(TRAIN_AGAINST_STEPS + PROFILE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for b in batches[:TRAIN_AGAINST_STEPS]:
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    peak = torch.cuda.max_memory_allocated()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        for b in batches[TRAIN_AGAINST_STEPS:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    share = _device_share({"prof": prof, "wall": wall}, PROFILE_TRAIN_STEPS)
    step_ms = statistics.median(times[2:]) * 1e3
    return {"tree": str(tree), "step_ms": step_ms,
            "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] * 1e3 / step_ms,
            "steps_ms": [round(t * 1e3, 2) for t in times],
            "losses": losses[:3], "held_bytes": held, "peak_bytes": peak,
            "device_ms_per_step": share.get("device_ms_per_step") or math.nan,
            "kernels_per_step": share.get("kernels") or math.nan,
            "top": [(n[:90], ms) for n, ms in share.get("top", [])]}


def train_against(other: Path, smi: str) -> dict:
    """The train step of this checkout beside that of the checkout at
    ``other``, each in a process of its own (each imports its own
    ``repro_torch`` and builds its own kernels), in the order other, this,
    this, other on one card."""
    out: dict = {"against": str(other), "card": smi, "readings": []}
    for tree in (other, ROOT, ROOT, other):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--train-step", str(tree)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise RuntimeError(f"train step of {tree} failed:\n"
                               f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        out["readings"].append(got)
        log(f"  {'this' if tree == ROOT else 'other':<5} median step "
            f"{got['step_ms']:.2f} ms, {got['tokens_per_s']:.0f} tokens/s, "
            f"device {got['device_ms_per_step']:.2f} ms and "
            f"{got['kernels_per_step']:.0f} kernels a step, memory held "
            f"{got['held_bytes'] / 1e9:.3f} GB, peak "
            f"{got['peak_bytes'] / 1e9:.3f} GB; first losses "
            f"{[round(x, 6) for x in got['losses']]}")
    return out


def _texts(n: int, seed: int, lo: int = 540, hi: int = 700) -> list[dict]:
    """Request texts of lo-hi characters (a token each): words over a small
    alphabet."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out = []
    for i in range(n):
        length = int(rng.randint(lo, hi + 1))
        words = []
        while sum(len(w) + 1 for w in words) < length:
            words.append("".join(rng.choice(letters, rng.randint(2, 10))))
        out.append({"id": f"req{i:02d}", "text": " ".join(words)[:length]})
    return out


def _serving_model(models, configs, cfg=None, dtype=torch.bfloat16):
    """Random weights (seed 0) for ``cfg`` (the serving cell's by default),
    drawn on the card in ``dtype``."""
    cfg = cfg or configs.get_config(SERVE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = models.init_params(models.model_spec(cfg), gen, dtype, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in _leaves(params))
    kinds = cfg.layer_kinds()
    mix = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
    extra = ""
    if cfg.moe is not None:
        extra += (f", MoE {cfg.moe.n_experts} experts top-{cfg.moe.top_k} "
                  f"of {cfg.moe.d_expert} + {cfg.moe.n_shared} shared")
    if cfg.mla is not None:
        extra += f", MLA latent {cfg.mla.kv_lora_rank} + rope " \
                 f"{cfg.mla.rope_head_dim}"
    log(f"  {cfg.name}: {cfg.n_layers} layers ({mix}), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads on {cfg.n_kv_heads} KV head(s) "
        f"of {cfg.head_dim}, vocab {cfg.vocab_size}{extra}; {n / 1e9:.3f} B "
        f"params ({n * torch.empty((), dtype=dtype).element_size() / 1e9:.2f}"
        f" GB) in {str(dtype).replace('torch.', '')} drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
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


def _device_share(trace: dict, steps: int = PROFILE_STEPS) -> dict | None:
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
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"busy": busy / wall_us, "device_ms_per_step":
            busy / 1e3 / steps, "wall_ms_per_step":
            wall_us / 1e3 / steps, "kernels": len(spans) /
            steps, "top": [(n, v / 1e3 / steps) for n, v in ranked[:8]],
            "by_kernel": [(n, v / 1e3 / steps) for n, v in ranked]}


def phase_serving(fd, cfg, params, serve, KsaCluster, ResourceProfile, *,
                  texts=None, engine_kw=None, n_dense=None, n_paged=None,
                  plain_watch=None) -> dict:
    """A ``serve_pipeline`` campaign through ``KsaCluster`` on one GPU
    worker whose engine (8 slots, flash decode; gemma3-1b's serving cell:
    paged, max_len 1024, pages of 64, unless ``engine_kw`` says otherwise)
    answers ``texts``; asserts ``n_dense`` dense and ``n_paged`` paged
    flash-decode launches an engine step (the local and global attention
    layers by default) and, with ``plain_watch``, no plain attention on the
    card."""
    kinds = cfg.layer_kinds()
    n_dense = kinds.count("local") if n_dense is None else n_dense
    n_paged = kinds.count("attn") if n_paged is None else n_paged
    kw = dict(paged=True, page_size=64, max_len=1024) if engine_kw is None \
        else engine_kw
    eng = serve.ServeEngine(cfg, params, decode_kernel="flash", n_slots=8,
                            device="cuda", **kw)
    eng.run_until_drained([("warm-up", [1, 2, 3, 4, 5], 2)])  # first launches
    serve.ServeRequestComputing.engine = eng
    step_s: list = []
    trace: dict = {}
    texts = texts or _texts(N_TEXTS, seed=1)
    lens = [len(x["text"]) for x in texts]
    # trace steps late in the first generate task's prompts: the rings are
    # full and every slot holds about 9 pages
    _timed_serve(eng, step_s, profile_at=min(lens[:8]) - 2 * PROFILE_STEPS,
                 trace=trace)
    try:
        with KsaCluster(workers=1,
                        session_timeout_s=SESSION_TIMEOUT_S) as c:
            c.add_worker(slots=1, profile=ResourceProfile(cpus=2, gpus=1,
                                                          mem_mb=4096))
            spec = serve.serve_pipeline(batch_size=8,
                                        vocab_size=cfg.vocab_size,
                                        max_new=MAX_NEW)
            steps0 = eng.steps
            torch.cuda.reset_peak_memory_stats()
            with plain_watch or contextlib.nullcontext({}) as plain:
                fd.flash_decode.launches = 0   # count only this path's run
                fd.flash_decode_paged.launches = 0
                res = c.run_campaign(spec, texts,
                                     timeout_s=CAMPAIGN_TIMEOUT_S)
                dense = fd.flash_decode.launches
                paged = fd.flash_decode_paged.launches
            steps = eng.steps - steps0
            peak = torch.cuda.max_memory_allocated()
            rep = c.campaign_report(res.campaign_id)
    finally:
        serve.ServeRequestComputing.engine = None
    assert res.status.state == "COMPLETED", res.status.state
    agg = res.final
    assert agg["n_requests"] == len(texts), agg["n_requests"]
    assert all(r["n_tokens"] == MAX_NEW for r in agg["responses"].values())
    if eng.allocator is not None:
        assert eng.allocator.used_pages == 0, eng.allocator.used_pages
        eng.allocator.check()
    assert steps > 0 and dense == n_dense * steps and paged == n_paged * steps, \
        (steps, dense, paged)
    assert not plain, f"plain versions ran on the card: {plain}"
    tokens = agg["total_tokens"]
    step_ms = statistics.median(step_s[-(steps - PROFILE_STEPS):]) * 1e3
    log(f"  {len(texts)} requests of {min(lens)}-{max(lens)} prompt tokens, "
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
        f"flash_decode_paged {paged} = {n_paged} x {steps}"
        f"{'; pages all returned' if eng.allocator is not None else ''}"
        f"{'; no plain version on the card' if plain_watch else ''}  ok; "
        f"peak device memory {peak / 1e9:.2f} GB")
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
        mine = [(re.search(r"\w+_kernel", n).group(0), ms)
                for n, ms in share["by_kernel"]
                if re.search(r"(ssd|flash)_\w+_kernel", n)]
        log("  the port's kernels, device ms a step: " + (", ".join(
            f"{n} {ms:.4f}" for n, ms in mine) or "none recorded"))
    return {"makespan_s": res.elapsed_s, "tokens": tokens,
            "tokens_per_s": tokens / res.elapsed_s, "steps": steps,
            "step_ms": step_ms, "device": share, "peak_bytes": peak,
            "launches": {"flash_decode": dense,
                         "flash_decode_paged": paged}}


def _greedy_with_logits(serve, cfg, params, prompts, **kw) -> tuple:
    """Greedy tokens per request, and the logits row of each generated
    token."""
    kw.setdefault("max_len", 1024)
    eng = serve.ServeEngine(cfg, params, n_slots=N_EXACT, device="cuda", **kw)
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


def phase_exactness(cfg, params, serve, prompts=None, ref_kw=None,
                    variants=None) -> dict:
    """float32 at full width: the dense chunked engine (the reference) and
    the flash engines must give equal greedy tokens. Near-tie rule: if the
    first difference falls where the reference's top two logits lie within
    1e-3, that step's logits must agree within 1e-3 and the request is
    compared no further. ``cfg`` and ``params`` in float32 unless they are
    bf16 (gemma3-1b's serving cell), then cast; returns each engine's
    tokens and logits rows by label, the reference's under "reference"."""
    cfg32 = cfg.with_(dtype="float32")
    p32 = _map(lambda x: x.float(), params)
    prompts = prompts or [[ord(ch) % cfg.vocab_size for ch in x["text"]]
                          for x in _texts(N_TEXTS, seed=1)[:N_EXACT]]
    ref, ref_rows = _greedy_with_logits(serve, cfg32, p32, prompts,
                                        decode_kernel="chunked",
                                        **(ref_kw or {}))
    runs = {"reference": (ref, ref_rows)}
    if variants is None:
        variants = (("dense flash", dict(decode_kernel="flash")),
                    ("paged flash", dict(decode_kernel="flash", paged=True,
                                         page_size=64)))
    for label, kw in variants:
        got, rows = _greedy_with_logits(serve, cfg32, p32, prompts, **kw)
        runs[label] = (got, rows)
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
    return runs


def _first_layers(cfg, params, n_layers: int) -> tuple:
    """``cfg`` and ``params`` cut to their first whole periods and the
    tail: ``n_layers`` must keep the config's remainder."""
    cut = cfg.with_(n_layers=n_layers)
    assert cut.n_remainder == cfg.n_remainder, (n_layers, cfg.period)
    return cut, dict(params, periods=_map(lambda x: x[:cut.n_periods],
                                          params["periods"]))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


# -- the training path (phases 12-17) -----------------------------------------

TRAIN_ARCH = "mamba2_130m"
SSD_ATOL_F32, SSD_ATOL_BF16 = 1e-4, 5e-2    # tests/test_kernels.py
# the main shape in bf16 against the plain version in float32 on the same
# bf16 inputs: y is rounded to bf16 once (2^-9 relative), sums differ in
# order and chunk (the kernel's 32 against the model's 256)
SSD_MAIN_ATOL = 5e-2
BF16_FLOP_S = 989e12                        # H100 SXM dense bf16 tensor cores
# A training campaign: the arch at full width, batch x seq tokens a step,
# and mem_mb, the host memory a chunk may grow by (the checkpoint's host
# copy and its serialization buffers; the agent revokes a task past it).
# mamba2-130m: 1.8 GB of state, so 16 GB covers it.
TRAIN = dict(arch=TRAIN_ARCH, batch=8, seq=2048, total_steps=16,
             chunk_steps=8, mem_mb=16384)
RECOVERY = dict(TRAIN, total_steps=8, chunk_steps=4)
PROFILE_TRAIN_STEPS = 3


def phase_ssd_build(ssd, pending) -> None:
    report_build("ssd", pending.result())
    ssd._library()


def _ssd_args(case, dtype=torch.float32, grad=False):
    out = []
    for k in ("x", "dt", "a", "b", "c"):
        t = torch.from_numpy(case[k]).cuda()
        if k in ("x", "b", "c"):
            t = t.to(dtype)
        out.append(t.requires_grad_(grad))
    h0 = case["h0"]
    if h0 is not None:
        h0 = torch.from_numpy(h0).cuda().requires_grad_(grad)
    return out, h0


def ssd_main_inputs(seed: int = 0) -> dict:
    """The SSD inputs of one mamba2-130m layer at the training shape, made
    on the card, laid out as ssd_block hands them over: x a view of the
    conv output (B, S, di + 2N) and B, C slices of it (bf16); dt in
    [1e-3, 0.1] (the dt_bias init's range) and a in [-16, -1] (a_log's)."""
    import _ssd_cases as sc
    m = sc.MAIN_SHAPE
    b, s, h, p, n = m["b"], m["s"], m["h"], m["p"], m["n"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xbc = torch.randn((b, s, h * p + 2 * n), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    x = xbc[..., :h * p].reshape(b, s, h, p)
    dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.099 + 1e-3
    a = -(torch.rand((h,), generator=gen, device="cuda") * 15 + 1)
    return {"x": x, "dt": dt, "a": a, "b": xbc[..., h * p:h * p + n],
            "c": xbc[..., h * p + n:], "chunk": m["chunk"]}


def phase_ssd_check(ssd, sc) -> dict:
    """The kernel against its plain version on the card: the cases of
    tests/test_kernels.py, h0 / final state / ragged / overflowing chunks,
    the main shape in bf16 against plain float32, determinism, and the
    autograd function's gradients against autograd through the plain
    version."""
    err = 0.0
    for shape in sc.KERNEL_SHAPES:
        case = sc.kernel_case(*shape)
        for dtype, tol in ((torch.float32, SSD_ATOL_F32),
                           (torch.bfloat16, SSD_ATOL_BF16)):
            args, _ = _ssd_args(case, dtype)
            y, h = ssd.ssd_scan(*args, chunk=case["chunk"])
            torch.cuda.synchronize()
            wy, wh = ssd.ssd_scan_plain(*args, chunk=case["chunk"])
            torch.testing.assert_close(y.float(), wy.float(), atol=tol,
                                       rtol=tol)
            torch.testing.assert_close(h, wh, atol=tol, rtol=tol)
            e = float((y.float() - wy.float()).abs().max())
            if dtype == torch.float32:
                err = max(err, e)
            log(f"  {str(shape):<24} {str(dtype)[6:]:<8} max |kernel - "
                f"plain| y {e:.3g}, state {float((h - wh).abs().max()):.3g}"
                f"  ok")
    for name, case in sc.state_cases().items():
        args, h0 = _ssd_args(case)
        y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
        torch.cuda.synchronize()
        wy, wh = ssd.ssd_scan_plain(*args, chunk=case["chunk"], h0=h0)
        torch.testing.assert_close(y, wy, atol=SSD_ATOL_F32,
                                   rtol=SSD_ATOL_F32)
        torch.testing.assert_close(h, wh, atol=SSD_ATOL_F32,
                                   rtol=SSD_ATOL_F32)
        e = float((y - wy).abs().max())
        err = max(err, e)
        log(f"  {name:<24} S={case['x'].shape[1]:<4} h0="
            f"{case['h0'] is not None!s:<5} unmasked exponent max "
            f"{sc.unmasked_exponent_max(case):8.1f}: max |kernel - plain| y "
            f"{e:.3g}, state {float((h - wh).abs().max()):.3g}  ok")
    for name in ("h0", "ragged_100", "overflow"):
        case = sc.state_cases()[name]
        args, h0 = _ssd_args(case, grad=True)
        wy = torch.randn(args[0].shape, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(1))
        leaves = [*args] + ([h0] if h0 is not None else [])
        # the reference in float64 on the same inputs (see _ssd_bwd_f64)
        leaves64 = [t.detach().double().requires_grad_(True) for t in leaves]

        def grads(fn, ins):
            y, h = fn(*ins[:5], chunk=case["chunk"],
                      h0=ins[5] if h0 is not None else None)
            return torch.autograd.grad((y * wy).sum() + h.square().sum(),
                                       ins)
        before = ssd.ssd_scan.bwd_launches
        got = grads(ssd.ssd_scan, leaves)
        assert ssd.ssd_scan.bwd_launches == before + 1
        want = grads(ssd.ssd_scan_plain, leaves64)
        gerr = 0.0
        for g, w in zip(got, want):
            assert bool(torch.isfinite(g).all()), name
            torch.testing.assert_close(g.double(), w, atol=1e-4, rtol=1e-4)
            gerr = max(gerr, float((g - w).abs().max()))
        log(f"  SSDScanFn gradients, {name:<11}: x, dt, a, B, C"
            f"{', h0' if h0 is not None else ''} finite, one backward "
            f"launch, max |autograd(kernel) - autograd(plain f64)| "
            f"{gerr:.3g}  ok")

    t = ssd_main_inputs()
    args = [t[k] for k in ("x", "dt", "a", "b", "c")]
    y, h = ssd.ssd_scan(*args, chunk=t["chunk"])
    again = ssd.ssd_scan(*args, chunk=t["chunk"])
    torch.cuda.synchronize()
    assert torch.equal(y, again[0]) and torch.equal(h, again[1]), \
        "kernel not deterministic"
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    wy, wh = ssd.ssd_scan_plain(*f32, chunk=t["chunk"])
    main_err = float((y.float() - wy).abs().max())
    h_err = float((h - wh).abs().max() / wh.abs().max())
    torch.testing.assert_close(y.float(), wy, atol=SSD_MAIN_ATOL,
                               rtol=SSD_MAIN_ATOL)
    assert h_err <= 1e-3, h_err
    share = float(((y.float() - wy).abs()
                   / (SSD_MAIN_ATOL + SSD_MAIN_ATOL * wy.abs())).max())
    log(f"  main shape {tuple(t['x'].shape)} N={t['b'].shape[-1]} bf16, x "
        f"a strided view (row stride {t['x'].stride(1)}), vec loads "
        f"{ssd._vec(t['x'], t['b'], t['c'])}: max |kernel - plain fp32| y "
        f"{main_err:.3g} (|y| max {float(wy.abs().max()):.3g}; limit "
        f"{SSD_MAIN_ATOL} + {SSD_MAIN_ATOL} |y|, at most {share:.2f} of it "
        f"used), state relative {h_err:.3g} (limit 1e-3); two runs "
        f"bit-identical  ok")
    del wy, wh, f32
    torch.cuda.empty_cache()
    return {"max_abs_err": max(err, main_err), "main_err": main_err}


SSD_BWD_OUTS = ("dx", "ddt", "da", "dB", "dC", "dh0")


def _ssd_bwd_f64(ssd, args, gy, gh, chunk, h0):
    """ssd_scan_bwd_plain in float64 on the same float32 inputs. The
    reference is float64: where |cum| is large (up to 466 on the
    overflowing chunk, an ulp of 3e-5) the plain version's own float32
    exponents are off by the order of the 1e-4 tolerance, and its float32
    gradient differs from the kernel's by up to twice that."""
    def f64(t):
        return None if t is None else t.double()
    return ssd.ssd_scan_bwd_plain(*map(f64, args), f64(gy), f64(gh),
                                  chunk=chunk, h0=f64(h0))


def _cotangents(y, h, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype),
            torch.randn(h.shape, generator=gen, device="cuda"))


def phase_ssd_bwd_check(ssd, sc) -> dict:
    """The backward kernel against ssd_scan_bwd_plain: every case of the
    forward's in float32 (against the plain version in float64, 1e-4), one
    cotangent absent, the training shape in bf16 against the plain version
    in float32 by relative norm error, and determinism."""
    cases = {**sc.state_cases(), **{str(shape): sc.kernel_case(*shape)
                                    for shape in sc.KERNEL_SHAPES}}
    err = 0.0
    for name, case in cases.items():
        args, h0 = _ssd_args(case)
        y, h = ssd.ssd_scan(*args, chunk=case["chunk"], h0=h0)
        gy, gh = _cotangents(y, h)
        runs = [(gy, gh, "")] + ([(gy, None, " gy only"),
                                  (None, gh, " g_hfin only")]
                                 if name == "ragged_100" else [])
        for g_y, g_h, label in runs:
            got = ssd.ssd_scan_bwd(*args, g_y, g_h, h0=h0)
            torch.cuda.synchronize()
            want = _ssd_bwd_f64(ssd, args, g_y, g_h, case["chunk"], h0)
            worst = []
            for out, g, w in zip(SSD_BWD_OUTS, got, want):
                if g is None:
                    assert h0 is None and out == "dh0"
                    continue
                assert bool(torch.isfinite(g).all()), (name, out)
                torch.testing.assert_close(g.double(), w, atol=SSD_ATOL_F32,
                                           rtol=SSD_ATOL_F32, msg=out)
                e = float((g.double() - w).abs().max())
                err = max(err, e)
                worst.append(f"{out} {e:.2g}")
            log(f"  backward {name + label:<30} f32: max |kernel - plain "
                f"f64| " + ", ".join(worst) + "; finite  ok")

    t = ssd_main_inputs(seed=2)
    args = [t[k] for k in ("x", "dt", "a", "b", "c")]
    y, h = ssd.ssd_scan(*args, chunk=t["chunk"])
    gy, _ = _cotangents(y, h)
    # the training path's cotangents: gy, and none for the final state
    got = ssd.ssd_scan_bwd(*args, gy, None)
    again = ssd.ssd_scan_bwd(*args, gy, None)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[:5], again[:5])), \
        "backward kernel not deterministic"
    del again
    f32 = [a.float() if a.dtype == torch.bfloat16 else a for a in args]
    want = ssd.ssd_scan_bwd_plain(*f32, gy.float(), None, chunk=t["chunk"])
    rel = {}
    for out, g, w in zip(SSD_BWD_OUTS[:5], got, want):
        assert bool(torch.isfinite(g).all()), out
        rel[out] = float((g.float() - w).norm() / w.norm())
    log(f"  backward main shape {tuple(t['x'].shape)} bf16 (gy only, as in "
        f"training): ||kernel - plain fp32|| / ||plain fp32|| "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f" (limit {sc.BWD_REL_BF16}); two runs bit-identical")
    assert all(v <= sc.BWD_REL_BF16 for v in rel.values()), rel
    del got, want, f32, t, args
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "main_rel": rel}


def ssd_bound(x, b) -> tuple[float, str, dict]:
    """Least time for one ssd_scan at these shapes: each input read once
    (x, dt, a, B, C), y and the final state written once, at 3.35 TB/s;
    against the operations at the model's chunk (256) with C.B^T formed
    once per (batch row, chunk) on the lower triangle, M.X on the lower
    triangle, the inter-chunk C.h and the state update per head, at the
    bf16 tensor-core rate."""
    bb, s, h, p = x.shape
    n = b.shape[-1]
    e = x.element_size()
    nbytes = (2 * bb * s * h * p * e + bb * s * h * 4 + h * 4
              + 2 * bb * s * n * e + bb * h * p * n * 4)
    c = 256
    nc = -(-s // c)
    tri = c * (c + 1) // 2
    ops = (bb * nc * tri * n * 2
           + bb * h * nc * (tri * p * 2 + c * n * p * 2 + c * p * n * 2
                            + p * n * 2))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / BF16_FLOP_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "ops": ops,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def ssd_bwd_bound(x, b) -> tuple[float, str, dict]:
    """Least time for one backward at these shapes with the training path's
    cotangents (gy; none for the final state): x, gy, dt, a, B and C read
    once, dx, ddt, da, dB and dC written once, at 3.35 TB/s; against the
    operations at the model's chunk (256): C.B^T and the two dCB products
    per (batch row, chunk) on the lower triangle; per head dM = gY.X^T and
    M^T.gY on the lower triangle, the chunk state and its adjoint, gY.hz,
    B.Dn^T and X.Dn, and the two passes over the state, at the bf16
    tensor-core rate."""
    bb, s, h, p = x.shape
    n = b.shape[-1]
    e = x.element_size()
    nbytes = (3 * bb * s * h * p * e + 2 * bb * s * h * 4 + 2 * h * 4
              + 4 * bb * s * n * e)
    c = 256
    nc = -(-s // c)
    tri = c * (c + 1) // 2
    ops = (bb * nc * 3 * tri * n * 2
           + bb * h * nc * (2 * tri * p * 2 + 5 * c * n * p * 2
                            + 2 * p * n * 2))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / BF16_FLOP_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "ops": ops,
                                     "bytes_ms": t_bytes, "ops_ms": t_ops}


def _by_kernel(parts: dict) -> str:
    return ", ".join(f"{n} {t:.4f} ms" for n, t in parts.items()) or \
        "no device activity recorded"


def phase_ssd_timing(ssd) -> dict:
    t = ssd_main_inputs(seed=1)
    args = [t[k] for k in ("x", "dt", "a", "b", "c")]
    ms = _median_flushed(lambda: ssd.ssd_scan(*args, chunk=t["chunk"]), 20)
    plain_ms = _median_flushed(
        lambda: ssd.ssd_scan_plain(*args, chunk=t["chunk"]), 5, warmup=1)
    parts_ms = _kernel_ms(lambda: ssd.ssd_scan(*args, chunk=t["chunk"]))
    bound_ms, bound_by, parts = ssd_bound(t["x"], t["b"])
    log(f"  forward {tuple(t['x'].shape)} N={t['b'].shape[-1]} bf16: median "
        f"{ms:.4f} ms over 20 (L2 flushed); plain (chunk 256) {plain_ms:.3f} "
        f"ms over 5; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{parts['bytes'] / 1e6:.1f} MB -> {parts['bytes_ms']:.4f} ms, "
        f"{parts['ops'] / 1e9:.2f} GFLOP -> {parts['ops_ms']:.4f} ms at the "
        f"bf16 rate); {bound_ms / ms:.2%} of the bound, "
        f"{parts['ops'] / ms / 1e9:.1f} TFLOP/s, "
        f"{parts['bytes'] / ms / 1e6:.0f} GB/s; no PyTorch call computes "
        f"this scan (library_ms null); one call by kernel (torch.profiler, "
        f"mean of 20 calls, L2 warm): {_by_kernel(parts_ms)}")
    y, _ = ssd.ssd_scan(*args, chunk=t["chunk"])
    gy = torch.randn(y.shape, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda").to(y.dtype)
    del y
    bwd_ms = _median_flushed(lambda: ssd.ssd_scan_bwd(*args, gy, None), 20)
    bwd_plain_ms = _median_flushed(
        lambda: ssd.ssd_scan_bwd_plain(*args, gy, None, chunk=t["chunk"]),
        3, warmup=1)
    bwd_parts_ms = _kernel_ms(lambda: ssd.ssd_scan_bwd(*args, gy, None))
    bwd_bound_ms, bwd_by, bparts = ssd_bwd_bound(t["x"], t["b"])
    log(f"  backward (gy; no final-state cotangent, as in training): median "
        f"{bwd_ms:.4f} ms over 20 (L2 flushed); plain (chunk 256) "
        f"{bwd_plain_ms:.3f} ms over 3; bound {bwd_bound_ms:.4f} ms "
        f"({bwd_by}: {bparts['bytes'] / 1e6:.1f} MB -> "
        f"{bparts['bytes_ms']:.4f} ms, {bparts['ops'] / 1e9:.2f} GFLOP -> "
        f"{bparts['ops_ms']:.4f} ms); {bwd_bound_ms / bwd_ms:.2%} of the "
        f"bound, {bparts['ops'] / bwd_ms / 1e9:.1f} TFLOP/s; one call by "
        f"kernel: {_by_kernel(bwd_parts_ms)}")
    del t, args, gy
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": parts["bytes"], "ops": parts["ops"],
            "by_kernel": parts_ms, "bwd": {
                "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                "bound_ms": bwd_bound_ms, "bound_by": bwd_by,
                "bytes": bparts["bytes"], "ops": bparts["ops"],
                "by_kernel": bwd_parts_ms}}


def _ckpt_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _instrument_training(trainer, ckpt_mod) -> dict:
    """Time each train step (host clock, synchronised) and each checkpoint
    save/restore inside the tasks, into the returned record (installed
    once; each campaign phase clears the record first)."""
    record = {"steps": [], "resident": [], "saves": [], "restores": []}
    make = trainer.make_train_step
    mgr_cls = ckpt_mod.CheckpointManager

    def timed_make(cfg, ocfg, **kw):
        step = make(cfg, ocfg, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            record["resident"].append(torch.cuda.memory_allocated())
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            record["steps"].append(time.perf_counter() - t0)
            return out
        return timed
    trainer.make_train_step = timed_make

    save, restore = mgr_cls.save, mgr_cls.restore_latest

    def timed_save(self, step, tree, **kw):
        t0 = time.perf_counter()
        path = save(self, step, tree, **kw)
        record["saves"].append((step, time.perf_counter() - t0,
                                _ckpt_bytes(path)))
        return path

    def timed_restore(self, like, **kw):
        t0 = time.perf_counter()
        out = restore(self, like, **kw)
        record["restores"].append(time.perf_counter() - t0)
        return out
    mgr_cls.save, mgr_cls.restore_latest = timed_save, timed_restore
    return record


def _gpu_cluster(KsaCluster, session_timeout_s=SESSION_TIMEOUT_S):
    # phase 16 passes a 10 s session, so that its crashed agent's
    # partitions pass to the new one soon; an agent whose loop thread waits
    # on the GIL for a few seconds (a task thread serializing a 1.8 GB
    # checkpoint) must still not be evicted from its group
    return KsaCluster(prefix="train", task_timeout_s=20.0, max_attempts=4,
                      session_timeout_s=session_timeout_s,
                      default_partitions=2,
                      agent_kw=dict(heartbeat_interval_s=0.2))


@contextlib.contextmanager
def _depth_cut(trainer, layers):
    """While the block runs, every train chunk builds its full-width config
    with ``layers`` layers (the chunk's params name the arch alone; None
    leaves the depth as published)."""
    full = trainer._cfg_from_params
    if layers:
        trainer._cfg_from_params = lambda p: full(p).with_(n_layers=layers)
    try:
        yield
    finally:
        trainer._cfg_from_params = full


def _gpu_worker(c, ResourceProfile, run):
    return c.add_worker(slots=1, profile=ResourceProfile(
        cpus=2, gpus=1, mem_mb=run["mem_mb"]))


def _campaign(trainer, c, ckpt_dir, run):
    return trainer.TrainCampaign(
        c.broker, c.submitter, c.monitor, arch=run["arch"],
        ckpt_dir=str(ckpt_dir), total_steps=run["total_steps"],
        chunk_steps=run["chunk_steps"], batch=run["batch"], seq=run["seq"],
        timeout_s=900.0, smoke=False, device="cuda", mem_mb=run["mem_mb"])


def _describe(cfg, run) -> str:
    kinds = cfg.layer_kinds()
    if "ssd" in kinds:
        mix = (f"{kinds.count('ssd')} ssd; d_state {cfg.ssm.d_state}, "
               f"head_dim {cfg.ssm.head_dim}, {cfg.ssd_heads} SSD heads, "
               f"d_conv {cfg.ssm.d_conv}, chunk {cfg.ssm.chunk_size}")
    else:
        mix = (f"{len(kinds)} bidirectional" if cfg.encoder_only else
               f"{kinds.count('local')} local with window "
               f"{cfg.window_size}, {kinds.count('attn')} global")
        mix += (f"; {cfg.n_heads} heads on {cfg.n_kv_heads} KV head(s) of "
                f"{cfg.head_dim}, d_ff {cfg.d_ff}")
    return (f"{cfg.name}: {cfg.n_layers} layers ({mix}), d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}, "
            f"{'tied' if cfg.tie_embeddings else 'untied'} embeddings, "
            f"{cfg.dtype} params with an fp32 master; batch {run['batch']} x "
            f"{run['seq']} tokens")


def _log_chunk_errors(c, run) -> None:
    """The errors the campaign's chunk tasks reported, last attempt first."""
    for start in range(0, run["total_steps"], run["chunk_steps"]):
        e = c.monitor.task(f"train-{run['arch']}-s{start:06d}")
        for err in reversed(e.errors if e is not None else []):
            log(f"  chunk at step {start}, attempt {err['attempt']}: "
                f"{str(err['error'])[-3000:]}")


def _run_campaign(camp, c, run) -> dict:
    """camp.run() on a thread; fails as soon as a chunk has used up its
    attempts (the monitor would otherwise wait out the whole timeout),
    logging the errors its attempts reported."""
    box: dict = {}

    def drive():
        try:
            box["out"] = camp.run(wait_timeout=1200.0)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            box["error"] = exc
    th = threading.Thread(target=drive, daemon=True)
    th.start()
    while th.is_alive():
        th.join(timeout=0.5)
        for start in range(0, run["total_steps"], run["chunk_steps"]):
            e = c.monitor.task(f"train-{run['arch']}-s{start:06d}")
            if (e is not None and not e.done
                    and len(e.errors) >= c.monitor.max_attempts):
                _log_chunk_errors(c, run)
                raise AssertionError(f"chunk at step {start} failed "
                                     f"{len(e.errors)} attempts")
    if "error" in box:
        _log_chunk_errors(c, run)
        raise box["error"]
    return box["out"]


def phase_training(run, counted, trainer, train_step_mod, ckpt_mod, data,
                   configs, KsaCluster, ResourceProfile, record: dict,
                   workdir: Path, plain_watch=None) -> dict:
    """A TrainCampaign at full width on a GPU worker (its depth cut to
    ``run["layers"]`` if given). ``counted`` maps each
    kernel's name to (its wrapper, the wrapper's count attribute, launches
    expected per step): every count is set to 0 just before the campaign
    and read just after. ``plain_watch``, if given, counts calls of the
    plain versions on CUDA tensors during the campaign (it must see none).
    The memory resident at every step of a chunk that restored a checkpoint
    must equal chunk 1's at its last step within RESIDENT_REL (a restored
    state kept alive beside the new one would double it). The step is
    timed and traced apart, outside the campaign (phase_train_steps)."""
    cfg = configs.get_config(run["arch"])
    if run.get("layers"):
        cfg = cfg.with_(n_layers=run["layers"])
    tokens_per_step = run["batch"] * run["seq"]
    log(f"  {_describe(cfg, run)}")
    for k in record:
        record[k].clear()
    with _gpu_cluster(KsaCluster) as c, \
            _depth_cut(trainer, run.get("layers")):
        _gpu_worker(c, ResourceProfile, run)
        camp = _campaign(trainer, c, workdir, run)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for fn, attr, _ in counted.values():
            setattr(fn, attr, 0)           # count only the main path's run
        with plain_watch or contextlib.nullcontext({}) as plain_calls:
            t0 = time.perf_counter()
            out = _run_campaign(camp, c, run)
            makespan = time.perf_counter() - t0
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr, _) in counted.items()}
        peak = torch.cuda.max_memory_allocated()
        peak_reserved = torch.cuda.max_memory_reserved()
    steps = run["total_steps"]
    chunks = -(-steps // run["chunk_steps"])
    losses = [r["loss"] for r in camp.chunk_results]
    assert out["final_step"] == steps and out["chunks"] == chunks, out
    assert all(np.isfinite(losses)), losses
    for name, (_, _, per_step) in counted.items():
        assert launches[name] == per_step * steps, \
            f"{launches[name]} {name} launches, expected {per_step} x {steps}"
    assert not plain_calls, f"plain versions ran on the card: {plain_calls}"
    latest = ckpt_mod.CheckpointManager(workdir).latest()
    assert latest is not None and latest[0] == steps, latest
    step_ms = statistics.median(record["steps"]) * 1e3
    log(f"  campaign: {steps} steps in {out['chunks']} chunks of "
        f"{run['chunk_steps']}, makespan {makespan:.2f} s; loss by chunk "
        f"{[round(x, 4) for x in losses]}; median step {step_ms:.2f} ms "
        f"(host clock, synchronised, {len(record['steps'])} steps), "
        f"{1e3 / step_ms:.2f} steps/s, {tokens_per_step * 1e3 / step_ms:.0f} "
        f"tokens/s; steps/s by chunk (with restore and save) "
        f"{[round(r['steps_per_s'], 3) for r in camp.chunk_results]}")
    log("  launches: " + ", ".join(
        f"{name} {launches[name]} = {per} x {steps} steps"
        for name, (_, _, per) in counted.items())
        + ("; no plain-version call on a CUDA tensor" if plain_watch else "")
        + "  ok")
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  device memory: {held / 1e9:.2f} GB allocated before the campaign; "
        f"allocated at each step's start "
        f"{[round(x / 1e9, 2) for x in record['resident']]} GB; peak "
        f"(max_memory_allocated) {peak / 1e9:.2f} GB, reserved "
        f"{peak_reserved / 1e9:.2f} GB, of the card's {total / 1e9:.2f} GB")
    for step, sec, size in record["saves"]:
        log(f"  checkpoint save at step {step}: {sec:.2f} s, {size / 1e9:.3f} "
            f"GB on disk ({size / sec / 1e6:.0f} MB/s)")
    log(f"  checkpoint restores: {[round(x, 2) for x in record['restores']]} "
        f"s; checkpoint at step {latest[0]}: {latest[1].split('/')[-1]}")
    chunk = run["chunk_steps"]
    base = record["resident"][chunk - 1]
    rel = max(abs(x - base) / base for x in record["resident"][chunk:])
    assert rel <= RESIDENT_REL, (base, record["resident"])
    log(f"  resident at every step of the restored chunks within {rel:.2%} "
        f"of chunk 1's at its last step ({base / 1e9:.3f} GB; limit "
        f"{RESIDENT_REL:.0%})  ok")
    return {"launches": launches, "losses": losses, "makespan_s": makespan,
            "step_ms": step_ms, "saves": list(record["saves"]),
            "restores": list(record["restores"]), "peak_bytes": peak,
            "held_bytes": held, "resident_bytes": list(record["resident"])}


def phase_recovery(trainer, ckpt_mod, KsaCluster, ResourceProfile,
                   workdir: Path, counted: dict, record: dict,
                   plain_watch) -> dict:
    """8 steps in 2 chunks of 4 with the agent crashed in chunk 2; the
    monitor's watchdog resubmits; the step-8 checkpoint must equal the
    uninterrupted run's, leaf by leaf. ``counted`` as in phase_training:
    every step run (the crashed chunk's too; a step is never cut, the
    agent stops between steps) launches each kernel as often as given."""
    for k in record:
        record[k].clear()
    for fn, attr, _ in counted.values():
        setattr(fn, attr, 0)
    with _gpu_cluster(KsaCluster, session_timeout_s=10.0) as c, \
            plain_watch as plain_calls:
        a1 = _gpu_worker(c, ResourceProfile, RECOVERY)
        camp = _campaign(trainer, c, workdir / "run2", RECOVERY)
        box: dict = {}

        def drive():
            box["out"] = camp.run(wait_timeout=1200.0)
        t0 = time.perf_counter()
        th = threading.Thread(target=drive, daemon=True)
        th.start()
        tid = f"train-{TRAIN_ARCH}-s{RECOVERY['chunk_steps']:06d}"
        deadline = time.time() + 600
        while time.time() < deadline:
            e = c.monitor.task(tid)
            if e is not None and e.status == "RUNNING":
                break
            time.sleep(0.05)
        else:
            raise AssertionError("chunk 2 never started")
        a1.crash()
        t_crash = time.perf_counter()
        _gpu_worker(c, ResourceProfile, RECOVERY)
        th.join(timeout=1200)
        assert "out" in box, "campaign did not finish after the crash"
        resub = c.monitor.resubmissions
    out = box["out"]
    assert out["final_step"] == RECOVERY["total_steps"], out
    assert resub >= 1, resub
    ran = len(record["steps"])
    launches = {name: getattr(fn, attr)
                for name, (fn, attr, _) in counted.items()}
    for name, (_, _, per_step) in counted.items():
        assert launches[name] == per_step * ran, \
            f"{launches[name]} {name} launches, expected {per_step} x {ran}"
    assert not plain_calls, f"plain versions ran on the card: {plain_calls}"
    log(f"  {ran} steps run (the crashed chunk's included); launches: "
        + ", ".join(f"{name} {launches[name]} = {per} x {ran}"
                    for name, (_, _, per) in counted.items())
        + "; no plain-version call on a CUDA tensor  ok")
    log(f"  agent crashed in chunk 2 ({tid}) {t_crash - t0:.1f} s in; "
        f"{resub} resubmission(s); campaign done in "
        f"{time.perf_counter() - t0:.2f} s, final loss "
        f"{out['final_loss']:.6f}")
    step = RECOVERY["total_steps"]
    a = json.loads((workdir / "run1" / f"ckpt_{step:08d}" /
                    "manifest.json").read_text())
    b = json.loads((workdir / "run2" / f"ckpt_{step:08d}" /
                    "manifest.json").read_text())
    assert [e["name"] for e in a["leaves"]] == [e["name"] for e in b["leaves"]]
    differ = [ea["name"] for ea, eb in zip(a["leaves"], b["leaves"])
              if ea["crc"] != eb["crc"] or ea["nbytes"] != eb["nbytes"]]
    shards = sorted(p.name for p in (workdir / "run1" /
                                     f"ckpt_{step:08d}").glob("shard_*"))
    if not differ and not all(filecmp.cmp(
            workdir / "run1" / f"ckpt_{step:08d}" / f,
            workdir / "run2" / f"ckpt_{step:08d}" / f, shallow=False)
            for f in shards):
        differ = [e["name"] for e in a["leaves"]]
    if differ:
        log(f"  step-{step} checkpoints differ in {len(differ)} of "
            f"{len(a['leaves'])} leaves; largest |difference| per leaf:")
        trees = [ckpt_mod.restore_checkpoint(
            workdir / run / f"ckpt_{step:08d}", trainer.train_state_shapes(
                trainer._cfg_from_params({"arch": TRAIN_ARCH, "smoke": False}),
                trainer._ocfg_from_params({})),
            device="cpu")[0] for run in ("run1", "run2")]
        from repro_torch.tree import paths
        for (name, x), (_, y) in zip(paths(trees[0]), paths(trees[1])):
            if name in differ:
                log(f"    {name}: {float((x.float() - y.float()).abs().max()):.3g}")
        _name_nondeterministic_ops()
        return {"resubmissions": resub, "leaves": len(a["leaves"]),
                "bitwise": False, "differ": differ}
    log(f"  step-{step} checkpoint of the crashed run equals the "
        f"uninterrupted run's bit for bit: all {len(a['leaves'])} leaves "
        f"(crc32 and size per leaf, and the {len(shards)} shard files byte "
        f"for byte; losses {a['extra']['loss']:.6f} and "
        f"{b['extra']['loss']:.6f})  ok")
    return {"resubmissions": resub, "leaves": len(a["leaves"]),
            "bitwise": True}


def _name_nondeterministic_ops() -> None:
    """Runs each op of the train step that could vary from run to run twice
    on equal inputs and names those whose results differ."""
    from repro_torch.kernels import ssd
    from repro_torch.models.layers import _MatmulWideOut
    gen = torch.Generator(device="cuda").manual_seed(9)
    idx = torch.randint(0, 50280, (16384,), generator=gen, device="cuda")
    src = torch.randn((16384, 768), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    table = torch.randn((50280, 768), generator=gen, device="cuda",
                        dtype=torch.bfloat16, requires_grad=True)

    def runs(fn):
        first = fn()
        return max(float((fn() - first).abs().max()) for _ in range(2))
    probes = {
        "embedding gather backward (index_put_ accumulate)":
            lambda: torch.autograd.grad((table[idx].float() * src.float()).sum(),
                                        table)[0].float(),
        "unembed (_MatmulWideOut) backward":
            lambda: torch.autograd.grad(_MatmulWideOut.apply(
                src, table.T, torch.float32).square().mean(), table)[0].float(),
    }
    t = ssd_main_inputs(seed=3)
    xs = [t[k].detach().requires_grad_(True) for k in ("x", "dt", "a", "b", "c")]
    probes["ssd_scan forward (the CUDA kernel)"] = \
        lambda: ssd.ssd_scan(*[v.detach() for v in xs], chunk=256)[0].float()
    probes["SSDScanFn backward (the CUDA kernel)"] = lambda: torch.autograd.grad(
        ssd.ssd_scan(*xs, chunk=256)[0].float().square().mean(), xs[0])[0].float()
    for name, fn in probes.items():
        log(f"    run-to-run max |difference| of {name}: {runs(fn):.3g}")


def phase_train_exactness(ssd, train_step_mod, configs, optim,
                          tree) -> dict:
    """The same weights at full width cut to 2 layers, float32, one train
    step of batch 2 x 512 on the card (through the forward and backward
    kernels of both layers) and on the CPU (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(TRAIN_ARCH).with_(n_layers=2, dtype="float32")
    # eps as in tests/test_torch_train.py: Adam's first step divides each
    # element by its own gradient, so summation-order noise on a near-zero
    # gradient would otherwise become a difference of order lr
    ocfg = optim.OptimizerConfig(lr=1e-3, eps=1e-5, warmup_steps=0,
                                 schedule="constant", weight_decay=0.1)
    state = train_step_mod.init_train_state(
        cfg, ocfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.RandomState(5)
    tok = rng.randint(0, cfg.vocab_size, (2, 513))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(tok[:, 1:].astype(np.int32))}
    step = train_step_mod.make_train_step(cfg, ocfg)
    on_card = tree.tree_map(lambda t: t.cuda(), state)
    before = ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches
    t0 = time.perf_counter()
    got, gm = step(on_card, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    assert (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches) == \
        (before[0] + 2, before[1] + 2), "the card's step skipped a kernel"
    t0 = time.perf_counter()
    want, wm = step(state, batch)
    t_cpu = time.perf_counter() - t0
    loss_err = abs(float(gm["loss"]) - float(wm["loss"]))
    gn_err = abs(float(gm["grad_norm"]) - float(wm["grad_norm"]))
    assert loss_err <= 1e-5 * abs(float(wm["loss"])), loss_err
    assert gn_err <= 1e-4 * abs(float(wm["grad_norm"])), gn_err
    worst, where = 0.0, ""
    for (name, g), w in zip(tree.paths(got.params), tree.leaves(want.params)):
        e = float((g.cpu() - w).abs().max())
        if e > worst:
            worst, where = e, name
    assert worst <= 1e-5, (worst, where)
    log(f"  {cfg.name} cut to 2 layers, float32, batch 2 x 512: loss card "
        f"{float(gm['loss']):.6f} CPU {float(wm['loss']):.6f} (|diff| "
        f"{loss_err:.3g}, limit 1e-5 relative); grad norm |diff| {gn_err:.3g}"
        f" (limit 1e-4 relative); updated params max |card - CPU| "
        f"{worst:.3g} at {where} (limit 1e-5); 2 forward and 2 backward "
        f"SSD launches on the card; step {t_card:.2f} s card, "
        f"{t_cpu:.2f} s CPU  ok")
    return {"loss_err": loss_err, "param_err": worst}


# -- the attention training path (phases 18-22) -------------------------------

ATTN_ARCH = "gemma3_1b"
FA_ATOL_F32, FA_ATOL_BF16 = 2e-5, 2e-2      # tests/test_kernels.py
FA_GRAD_ATOL = 1e-5
# the log-sum-exp against the plain version's on the same inputs: fp32
# sums in another order, exp2/log2 against exp/log
FA_LSE_ATOL = 1e-5
# the float32 backward (FMAs on the mma fragment layout, no TF32) at the
# model shapes, against float64 autograd: a key's dk and dv there sum
# S x G terms (up to 16384) in fp32 in order, and the plain version's own
# fp32 sums are up to 3.3e-5 from float64 on the same inputs, so neither
# holds 1e-5 + 1e-5 |other| against the other on every element
FA_GRAD_ATOL_MODEL = 4e-5
# the bf16 backward at the model shapes, per tensor: ||kernel - plain fp32||
# over ||plain fp32||, beside the per-element limit FA_ATOL_BF16 (whose
# absolute floor is of the order of a typical |grad| on long rows); 2.35e-3
# measured on every shape, about what rounding the outputs to bf16 costs
FA_BWD_REL_BF16 = 5e-3
# the bf16 forward at S = 32768, per tensor: ||kernel - plain fp32|| over
# ||plain fp32||. There the softmax over 32768 keys is nearly uniform and a
# typical |out| is below 0.01, so the per-element limit FA_ATOL_BF16 is
# twice what it compares or more; the norm holds the V side (a tile of 64
# V rows skipped moves it by about 4e-2, one read from the wrong rows by
# about 7e-2, on N(0, 1) inputs at D = 80). Rounding the output to bf16
# alone costs about 1.7e-3.
FA_LONG_REL_BF16 = 5e-3
# gemma3-1b at full width, its depth cut to one whole 5:1 period (5 local
# layers, 1 global): 0.46 B parameters, of which the tied 262144 x 1152
# table 0.30 B; 6.4 GB of state (bf16 params, fp32 master, m, v). A chunk's
# host memory holds a copy of it plus the shard buffers of its checkpoint
# while they are compressed. The batch is cut from the train_4k shape's 256
# sequences to two. Two chunks: the second restores the first's checkpoint.
# The full 26-layer step is timed apart, outside the campaign
# (phase_train_steps).
ATTN_TRAIN = dict(arch=ATTN_ARCH, batch=2, seq=4096, total_steps=8,
                  chunk_steps=4, mem_mb=65536, layers=6)
# the memory resident at each step of a restored chunk against chunk 1's at
# its last step (chunk 1's first step may precede the card's lazily made
# workspaces): a restored state kept alive beside the step's would double it
RESIDENT_REL = 0.01
FA_TIMED = ("gemma3_1b_global", "gemma3_1b_local", "stablelm_1_6b")


FA_PLAIN = ("flash_attention_plain", "flash_attention_lse_plain",
            "flash_attention_bwd_plain")
SSD_PLAIN = ("ssd_scan_plain", "ssd_scan_bwd_plain")


@contextlib.contextmanager
def plain_calls_on_card(targets):
    """Counts, by name, the calls of the functions ``targets`` names (pairs
    of a module and a name: the kernels' plain versions, and the model's
    chunked_attention, the plain attention forward) made with a CUDA tensor
    while the block runs."""
    seen: dict = {}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counting(name, fn):
        def call(*args, **kw):
            if args and args[0].is_cuda:
                seen[name] = seen.get(name, 0) + 1
            return fn(*args, **kw)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield seen
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def phase_fa_build(fa, pending) -> None:
    report_build("flash_attention", pending.result())
    fa._library()


def _fa_kw(case) -> dict:
    return dict(causal=case["causal"], window=case["window"],
                q_offset=case["q_offset"])


def fa_model_inputs(shape: dict, seed: int = 0,
                    dtype: torch.dtype = torch.bfloat16) -> list:
    """q, k, v of one whole-sequence attention call at a model's width,
    made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s, d = shape["b"], shape["s"], shape["d"]
    return [torch.randn((b, s, h, d), generator=gen, device="cuda",
                        dtype=dtype)
            for h in (shape["h"], shape["kh"], shape["kh"])]


def _fa_grads(fa, q, k, v, g, kw):
    """The kernels' forward (out, lse) and backward (dq, dk, dv) on q, k, v
    and the output gradient g, and the plain backward in float32 on the
    same inputs and the kernel's own out and lse."""
    out, lse = fa.flash_attention_forward(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    want = fa.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, out)),
                                        lse, g.float(), **kw)
    return out, lse, got, want


def _close(got, want, tol) -> float:
    """max |got - want| over the tensors, after assert_close at tol."""
    err = 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b, atol=tol, rtol=tol)
        err = max(err, float((a.float() - b).abs().max()))
    return err


def _attention_grads_f64(q, k, v, g, causal, window) -> list:
    """dq, dk, dv in float64 by autograd through dense masked softmax
    attention (GQA by repeating each KV head over its group)."""
    b, s, h, d = q.shape
    grp = h // k.shape[2]
    q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
    scores = torch.einsum("bqhd,bkhd->bhqk", q64,
                          k64.repeat_interleave(grp, dim=2)) / d ** 0.5
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = torch.ones((s, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        valid &= kp <= qp
    if window is not None:
        valid &= kp > qp - window
    p = torch.softmax(scores.masked_fill(~valid, -torch.inf), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p,
                       v64.repeat_interleave(grp, dim=2))
    grads = torch.autograd.grad((out * g.double()).sum(), (q64, k64, v64))
    return [t.float() for t in grads]


def _rel_norm(got, want, limit) -> float:
    """max over the tensors of ||got - want|| / ||want||, asserted within
    limit."""
    rel = max(float((a.float() - b).norm() / b.norm())
              for a, b in zip(got, want))
    assert rel <= limit, f"relative error {rel:.3g} over {limit:g}"
    return rel


def _grad_sizes(grads) -> str:
    """The largest and the median |grad| over dq, dk and dv."""
    return (f"|grad| max {max(float(t.abs().max()) for t in grads):.3g}, "
            f"median dq {float(grads[0].abs().median()):.3g} dk "
            f"{float(grads[1].abs().median()):.3g} dv "
            f"{float(grads[2].abs().median()):.3g}")


def phase_fa_check(fa, fc) -> dict:
    """The forward kernel against its plain versions on the card (output
    and log-sum-exp) and the backward kernel against its plain version, on
    every case in f32 and bf16, rows with no valid key, the model shapes in
    f32 and in bf16 against the plain versions in float32, determinism of
    both, and FlashAttentionFn's gradients against autograd through the
    plain version."""
    err, bwd_err = 0.0, 0.0
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, case in fc.kernel_cases().items():
        line = []
        for dtype, tol, gtol in ((torch.float32, case["tol"], FA_GRAD_ATOL),
                                 (torch.bfloat16, FA_ATOL_BF16,
                                  FA_ATOL_BF16)):
            q, k, v = (torch.from_numpy(case[n]).cuda().to(dtype)
                       for n in ("q", "k", "v"))
            g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            got = fa.flash_attention(q, k, v, **_fa_kw(case))
            out, lse, grads, want_g = _fa_grads(fa, q, k, v, g, _fa_kw(case))
            assert torch.equal(got, out)
            plain = [t.float() for t in (q, k, v)]
            want = fa.flash_attention_plain(*plain, **_fa_kw(case))
            want_lse = fa.flash_attention_lse_plain(*plain[:2],
                                                    **_fa_kw(case))
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(got.float(), want, atol=tol, rtol=tol)
            torch.testing.assert_close(lse, want_lse, atol=FA_LSE_ATOL,
                                       rtol=FA_LSE_ATOL)
            e = float((got.float() - want).abs().max())
            ge = _close(grads, want_g, gtol)
            if dtype == torch.float32:
                err, bwd_err = max(err, e), max(bwd_err, ge)
            line.append(f"{str(dtype)[6:]} {e:.3g}, lse "
                        f"{float((lse - want_lse).abs().max()):.3g}, "
                        f"dq/dk/dv {ge:.3g} (tol {tol:g}, {gtol:g})")
        log(f"  {name:<32} q {tuple(case['q'].shape)} k "
            f"{tuple(case['k'].shape)} offset {case['q_offset']}: max "
            f"|kernel - plain| {'; '.join(line)}  ok")
    case, empty = fc.empty_rows_case()
    q, k, v = (torch.from_numpy(case[n]).cuda() for n in ("q", "k", "v"))
    g = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse, grads, want_g = _fa_grads(fa, q, k, v, g, _fa_kw(case))
    want = fa.flash_attention_plain(q, k, v, **_fa_kw(case))
    keep = [i for i in range(q.shape[1]) if i not in empty]
    assert bool((out[:, empty] == 0).all()), "rows without keys not zero"
    assert bool((lse.transpose(1, 2)[:, empty] == -np.inf).all())
    assert bool((grads[0][:, empty] == 0).all()), "their dq is not zero"
    torch.testing.assert_close(out[:, keep], want[:, keep], atol=FA_ATOL_F32,
                               rtol=FA_ATOL_F32)
    _close(grads, want_g, FA_GRAD_ATOL)
    log(f"  rows without a valid key (positions {empty[0]}-{empty[-1]} of "
        f"{q.shape[1]}, Sk {k.shape[1]}, window {case['window']}): out, dq "
        f"exactly 0 and lse -inf; the other rows max |kernel - plain| "
        f"{float((out[:, keep] - want[:, keep]).abs().max()):.3g}  ok")

    main_err, main_bwd_err = {}, {}
    for name, shape in fc.MODEL_SHAPES.items():
        kw = dict(causal=shape["causal"], window=shape["window"])
        q, k, v = fa_model_inputs(shape, dtype=torch.float32)
        got, lse = fa.flash_attention_forward(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.testing.assert_close(got, want, atol=FA_ATOL_F32,
                                   rtol=FA_ATOL_F32)
        want_lse = fa.flash_attention_lse_plain(q, k, **kw)
        torch.testing.assert_close(lse, want_lse, atol=FA_LSE_ATOL,
                                   rtol=FA_LSE_ATOL)
        err = max(err, float((got - want).abs().max()))
        log(f"  {name:<17} B={shape['b']} S={shape['s']} H={shape['h']} "
            f"K={shape['kh']} D={shape['d']} causal={shape['causal']} "
            f"window={shape['window']}, f32: max |kernel - plain| "
            f"{float((got - want).abs().max()):.3g} (tol {FA_ATOL_F32:g}; "
            f"|out| median {float(want.abs().median()):.3g}), lse "
            f"{float((lse - want_lse).abs().max()):.3g} (tol "
            f"{FA_LSE_ATOL:g})  ok")
        del q, k, v, got, want, lse, want_lse
        # the float32 backward at the model's shape, against float64
        q, k, v = fa_model_inputs(shape, dtype=torch.float32)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        _, _, grads, want_g = _fa_grads(fa, q, k, v, g, kw)
        exact = _attention_grads_f64(q, k, v, g, **kw)
        ge = _close(grads, exact, FA_GRAD_ATOL_MODEL)
        pe = max(float((a - b).abs().max()) for a, b in zip(want_g, exact))
        bwd_err = max(bwd_err, ge)
        log(f"  {name:<17} backward, f32: max |dq, dk, dv - float64| "
            f"{ge:.3g} (tol {FA_GRAD_ATOL_MODEL:g}; the plain version's in "
            f"fp32 {pe:.3g}; {_grad_sizes(exact)})  ok")
        del q, k, v, g, grads, want_g, exact
        torch.cuda.empty_cache()
        q, k, v = fa_model_inputs(shape)
        got, lse = fa.flash_attention_forward(q, k, v, **kw)
        g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
        grads = fa.flash_attention_bwd(q, k, v, got, lse, g, **kw)
        if name == "gemma3_1b_global":
            again, lse2 = fa.flash_attention_forward(q, k, v, **kw)
            grads2 = fa.flash_attention_bwd(q, k, v, got, lse, g, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again) and torch.equal(lse, lse2), \
                "forward kernel not deterministic"
            assert all(torch.equal(a, b) for a, b in zip(grads, grads2)), \
                "backward kernel not deterministic"
            del again, lse2, grads2
        plain = [t.float() for t in (q, k, v)]
        want = fa.flash_attention_plain(*plain, **kw)
        torch.testing.assert_close(got.float(), want, atol=FA_ATOL_BF16,
                                   rtol=FA_ATOL_BF16)
        main_err[name] = float((got.float() - want).abs().max())
        share = float(((got.float() - want).abs()
                       / (FA_ATOL_BF16 + FA_ATOL_BF16 * want.abs())).max())
        del want
        want_g = fa.flash_attention_bwd_plain(*plain, got.float(), lse,
                                              g.float(), **kw)
        main_bwd_err[name] = _close(grads, want_g, FA_ATOL_BF16)
        rel = _rel_norm(grads, want_g, FA_BWD_REL_BF16)
        gshare = max(float(((a.float() - b).abs()
                            / (FA_ATOL_BF16 + FA_ATOL_BF16 * b.abs())).max())
                     for a, b in zip(grads, want_g))
        log(f"  {name:<17} B={shape['b']} S={shape['s']} H={shape['h']} "
            f"K={shape['kh']} D={shape['d']} causal={shape['causal']} "
            f"window={shape['window']}, bf16: max |kernel - plain fp32| "
            f"{main_err[name]:.3g} ({share:.2f} of the 2e-2 + 2e-2 |out| "
            f"limit used); backward max |dq, dk, dv - plain fp32| "
            f"{main_bwd_err[name]:.3g} ({_grad_sizes(want_g)}; {gshare:.2f} "
            f"of the limit used), ||dq, dk, dv - plain fp32|| / ||plain|| "
            f"at most {rel:.3g} (limit {FA_BWD_REL_BF16:g})"
            + ("; two runs bit-identical, forward and backward"
               if name == "gemma3_1b_global" else "") + "  ok")
        del q, k, v, got, lse, g, grads, want_g, plain
        torch.cuda.empty_cache()

    for name, shape in fc.LONG_SHAPES.items():
        main_err[name] = _fa_long_check(fa, name, shape)

    for name, case in (("window 40", fc.random_case(31, 2, 96, 96, 6, 2, 32,
                                                     window=40)),
                       ("causal, D 80", fc.random_case(32, 1, 70, 70, 4, 4,
                                                       80)),
                       ("offset", fc.offset_cases()["offset"])):
        w = torch.randn(case["q"].shape, generator=gen, device="cuda")

        def grads(fn):
            q, k, v = (torch.from_numpy(case[n]).cuda().requires_grad_(True)
                       for n in ("q", "k", "v"))
            out = fn(q, k, v, kv_chunk=32, **_fa_kw(case))
            return torch.autograd.grad((out * w).sum(), (q, k, v))
        before = fa.flash_attention.bwd_launches
        got = grads(fa.flash_attention)
        assert fa.flash_attention.bwd_launches == before + 1
        gerr = _close(got, grads(fa.flash_attention_plain), FA_GRAD_ATOL)
        log(f"  FlashAttentionFn gradients, {name:<12}: q, k, v max "
            f"|autograd(kernel) - autograd(plain)| {gerr:.3g} (limit "
            f"{FA_GRAD_ATOL:g}), one backward launch  ok")
    return {"max_abs_err": max(err, *main_err.values()), "f32_err": err,
            "main_err": main_err, "bwd_f32_err": bwd_err,
            "bwd_main_err": main_bwd_err}


def _fa_long_check(fa, name, shape) -> float:
    """The forward kernel at a long sequence in bf16 (output and
    log-sum-exp) against the plain versions in float32 on the same bf16
    inputs, every query row; twice bit-identical."""
    kw = dict(causal=shape["causal"], window=shape["window"])
    q, k, v = fa_model_inputs(shape, seed=5)
    got, lse = fa.flash_attention_forward(q, k, v, **kw)
    again, lse2 = fa.flash_attention_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse2), \
        "forward kernel not deterministic"
    del again, lse2
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(lse).all())
    plain = [t.float() for t in (q, k, v)]
    want = fa.flash_attention_plain(*plain, **kw)
    torch.testing.assert_close(got.float(), want, atol=FA_ATOL_BF16,
                               rtol=FA_ATOL_BF16)
    err = float((got.float() - want).abs().max())
    rel = _rel_norm([got], [want], FA_LONG_REL_BF16)
    typical = float(want.abs().median())
    del want
    want_lse = fa.flash_attention_lse_plain(*plain[:2], **kw)
    torch.testing.assert_close(lse, want_lse, atol=FA_LSE_ATOL,
                               rtol=FA_LSE_ATOL)
    lse_err = float((lse - want_lse).abs().max())
    log(f"  {name:<17} B={shape['b']} S={shape['s']} H={shape['h']} "
        f"K={shape['kh']} D={shape['d']} causal={shape['causal']}, bf16, "
        f"forward: max |kernel - plain fp32| {err:.3g} (tol {FA_ATOL_BF16:g}"
        f"; median |out| {typical:.3g}), ||kernel - plain fp32|| / ||plain|| "
        f"{rel:.3g} (limit {FA_LONG_REL_BF16:g}), lse {lse_err:.3g} (tol {FA_LSE_ATOL:g}) over all "
        f"{shape['b'] * shape['h'] * shape['s']} rows; lse buffer "
        f"{tuple(lse.shape)}; two runs bit-identical  ok")
    del q, k, v, got, lse, want_lse, plain
    torch.cuda.empty_cache()
    return err


def attention_bound(b, sq, sk, h, kh, d, causal, window, elem,
                    q_offset=0, backward=False) -> tuple[float, str, dict]:
    """Least time for one attention call at the bf16 tensor-core rate and
    3.35 TB/s. Forward: the two products over the live (query head, key)
    pairs, 4 D operations each, against Q, K, V read once and O written
    once. Backward: the five products (S, dP = dO.V^T, dV, dK, dQ), 10 D
    operations a live pair, against Q, K, V, O and dO read once and dQ, dK,
    dV written once."""
    pos = q_offset + np.arange(sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, int)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum()) * b * h
    per_pair, q_like = (10, 4) if backward else (4, 2)
    ops = per_pair * d * pairs
    nbytes = elem * d * q_like * (b * sq * h + b * sk * kh)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / BF16_FLOP_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, {"bytes": nbytes, "ops": ops,
                                     "pairs": pairs, "bytes_ms": t_bytes,
                                     "ops_ms": t_ops}


def _sdpa_call(q, k, v, shape, grad=False):
    """scaled_dot_product_attention on (B, H, S, D) copies: is_causal for a
    causal shape, a boolean band for a window, GQA by enable_gqa. With
    ``grad`` the copies are leaves that require gradients; they are
    returned with the call."""
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(grad)
                  for t in (q, k, v))
    s = q.shape[1]
    mask, causal = None, shape["causal"]
    if shape["window"] is not None:
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                             - shape["window"])
        causal = False
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(qt, kt, vt, attn_mask=mask, is_causal=causal,
                    enable_gqa=shape["h"] != shape["kh"])
    return (call, (qt, kt, vt)) if grad else call


def _grad_call(out, ins, g):
    """One backward through the graph that made ``out`` (kept for the next
    call), seeded with ``g``: the time of the backward alone."""
    def call():
        return torch.autograd.grad(out, ins, g, retain_graph=True)
    return call


def _sdpa_backend(call, backward=False) -> str:
    """The backend one SDPA call dispatched to: the name of the ATen op
    it ran (``aten::_scaled_dot_product_<backend>_attention``, or its
    ``_backward`` when ``call`` runs the backward)."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if (e.name.startswith("aten::_scaled_dot_product_")
                 or e.name.startswith("aten::_efficient_attention")
                 or e.name.startswith("aten::_flash_attention"))
             and e.name.endswith("_backward") == backward]
    return names[0] if names else "not recorded"


def _kernel_ms(call, runs: int = 20) -> dict:
    """Device ms of one run of ``call`` by kernel (torch.profiler): each
    kernel's total over ``runs`` runs over ``runs`` (a kernel launched
    twice a run counts both), the names cut to the kernel's own; empty
    when the profiler records no device activity."""
    call()
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(runs):
            call()
        torch.cuda.synchronize()
    total: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"\w+_kernel", e.name)
            name = found.group(0) if found else e.name[:60]
            t, n = total.get(name, (0.0, 0))
            total[name] = (t + (e.time_range.end - e.time_range.start) / 1e3,
                           n + 1)
    return {name: t / runs for name, (t, _) in total.items()}


def phase_fa_timing(fa, fc) -> dict:
    """At each timed shape in bf16: the forward kernel, its earlier fp32 FMA
    design (the float32 path, run on bf16 inputs), its plain version
    and SDPA's forward; the backward kernel, its plain version and SDPA's
    backward (``autograd.grad`` through its graph, kept between runs); and
    both bounds."""
    out = {}
    for name in FA_TIMED:
        shape = fc.MODEL_SHAPES[name]
        q, k, v = fa_model_inputs(shape, seed=1)
        kw = dict(causal=shape["causal"], window=shape["window"])
        ms = _median_flushed(lambda: fa.flash_attention(q, k, v, **kw), 20)
        fma_ms = _median_flushed(
            lambda: fa._launch(q, k, v, q_offset=0, fma=True, **kw), 10)
        plain_ms = _median_flushed(
            lambda: fa.flash_attention_plain(q, k, v, **kw), 5, warmup=1)
        library = _sdpa_call(q, k, v, shape)
        o, lse = fa.flash_attention_forward(q, k, v, **kw)
        torch.testing.assert_close(library().transpose(1, 2).float(),
                                   o.float(), atol=FA_ATOL_BF16,
                                   rtol=FA_ATOL_BF16)
        library_ms = _median_flushed(library, 20)
        backend = _sdpa_backend(library)
        del library
        bound_ms, bound_by, parts = attention_bound(
            shape["b"], shape["s"], shape["s"], shape["h"], shape["kh"],
            shape["d"], shape["causal"], shape["window"], q.element_size())
        log(f"  {name:<17} B={shape['b']} S={shape['s']} H={shape['h']} "
            f"K={shape['kh']} D={shape['d']} window={shape['window']} bf16: "
            f"forward kernel {ms:.4f} ms (earlier FMA design {fma_ms:.4f} "
            f"ms, {fma_ms / ms:.1f}x), plain {plain_ms:.3f} ms, sdpa "
            f"{library_ms:.4f} ms ({backend}); bound {bound_ms:.4f} ms "
            f"({bound_by}: {parts['ops'] / 1e9:.2f} GFLOP over "
            f"{parts['pairs']} live pairs -> {parts['ops_ms']:.4f} ms at "
            f"the bf16 rate, {parts['bytes'] / 1e6:.1f} MB -> "
            f"{parts['bytes_ms']:.4f} ms); {bound_ms / ms:.2%} of the bound, "
            f"{parts['ops'] / ms / 1e9:.1f} TFLOP/s")

        gen = torch.Generator(device="cuda").manual_seed(2)
        g = torch.randn(q.shape, generator=gen, device="cuda", dtype=q.dtype)
        bwd_ms = _median_flushed(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, **kw), 20)
        bwd_plain_ms = _median_flushed(
            lambda: fa.flash_attention_bwd_plain(q, k, v, o, lse, g, **kw),
            5, warmup=1)
        parts_ms = _kernel_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, g, **kw))
        got = fa.flash_attention_bwd(q, k, v, o, lse, g, **kw)
        torch.cuda.empty_cache()
        lib_call, lib_ins = _sdpa_call(q, k, v, shape, grad=True)
        lib_o = lib_call()
        lib_grad = _grad_call(lib_o, lib_ins, g.transpose(1, 2).contiguous())
        library_bwd_ms = _median_flushed(lib_grad, 20)
        bwd_backend = _sdpa_backend(lib_grad, backward=True)
        lib_diff = max(float((a.float() - b.transpose(1, 2).float())
                             .abs().max()) for a, b in zip(got, lib_grad()))
        del lib_o, lib_ins, lib_call, lib_grad, got
        bwd_bound_ms, bwd_by, bparts = attention_bound(
            shape["b"], shape["s"], shape["s"], shape["h"], shape["kh"],
            shape["d"], shape["causal"], shape["window"], q.element_size(),
            backward=True)
        log(f"  {name:<17} backward: kernel {bwd_ms:.4f} ms, plain "
            f"{bwd_plain_ms:.3f} ms, sdpa backward {library_bwd_ms:.4f} ms "
            f"({bwd_backend}; max |dq, dk, dv - sdpa's| {lib_diff:.3g}); "
            f"bound {bwd_bound_ms:.4f} ms ({bwd_by}: "
            f"{bparts['ops'] / 1e9:.2f} GFLOP -> {bparts['ops_ms']:.4f} ms, "
            f"{bparts['bytes'] / 1e6:.1f} MB -> {bparts['bytes_ms']:.4f} "
            f"ms); {bwd_bound_ms / bwd_ms:.2%} of the bound, "
            f"{bparts['ops'] / bwd_ms / 1e9:.1f} TFLOP/s of the five "
            f"products; one call by kernel (torch.profiler, mean of the "
            f"launches recorded in 20 calls, L2 warm): " + (", ".join(f"{n} {t:.4f} ms"
                                    for n, t in parts_ms.items())
                          or "no device activity recorded"))
        out[name] = {"ms": ms, "fma_ms": fma_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "library_backend": backend,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "gflop": parts["ops"] / 1e9, "shape": shape, "bwd": {
                         "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                         "library_ms": library_bwd_ms,
                         "library_backend": bwd_backend,
                         "bound_ms": bwd_bound_ms, "bound_by": bwd_by,
                         "gflop": bparts["ops"] / 1e9, "by_kernel": parts_ms}}
        del q, k, v, o, lse, g
        torch.cuda.empty_cache()
    return out


def phase_attn_exactness(fa, train_step_mod, configs, optim, tree) -> dict:
    """gemma3-1b at full width cut to 2 layers, one local and one global,
    float32, one train step of batch 2 x 768 (past the 512-key window) on
    the card and on the CPU (TF32 off)."""
    cfg = configs.get_config(ATTN_ARCH).with_(
        n_layers=2, layer_pattern=("local", "attn"), dtype="float32")
    rng = np.random.RandomState(6)
    tok = rng.randint(0, cfg.vocab_size, (2, 769))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(tok[:, 1:].astype(np.int32))}
    return _train_step_card_vs_cpu(fa, train_step_mod, optim, tree, cfg,
                                   batch, "batch 2 x 768")


def _train_step_card_vs_cpu(fa, train_step_mod, optim, tree, cfg, batch,
                            what) -> dict:
    """One float32 train step of ``cfg`` on ``batch`` (CPU tensors) on the
    card and on the CPU (TF32 off), from the same state (seed 3): loss and
    grad norm within 1e-5 relative, updated params within 1e-5; the card's
    step launches the forward and backward kernels once a layer."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # eps as in tests/test_torch_train.py and phase 17
    ocfg = optim.OptimizerConfig(lr=1e-3, eps=1e-5, warmup_steps=0,
                                 schedule="constant", weight_decay=0.1)
    state = train_step_mod.init_train_state(
        cfg, ocfg, torch.Generator().manual_seed(3), "cpu")
    step = train_step_mod.make_train_step(cfg, ocfg)
    on_card = tree.tree_map(lambda t: t.cuda(), state)
    before = fa.flash_attention.launches, fa.flash_attention.bwd_launches
    t0 = time.perf_counter()
    got, gm = step(on_card, {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    n = cfg.n_layers
    assert (fa.flash_attention.launches, fa.flash_attention.bwd_launches) \
        == (before[0] + n, before[1] + n), "the card's step skipped a kernel"
    t0 = time.perf_counter()
    want, wm = step(state, batch)
    t_cpu = time.perf_counter() - t0
    loss_err = abs(float(gm["loss"]) - float(wm["loss"]))
    gn_err = abs(float(gm["grad_norm"]) - float(wm["grad_norm"]))
    assert loss_err <= 1e-5 * abs(float(wm["loss"])), loss_err
    assert gn_err <= 1e-5 * abs(float(wm["grad_norm"])), gn_err
    worst, where = 0.0, ""
    for (name, g), w in zip(tree.paths(got.params), tree.leaves(want.params)):
        e = float((g.cpu() - w).abs().max())
        if e > worst:
            worst, where = e, name
    assert worst <= 1e-5, (worst, where)
    log(f"  {cfg.name} cut to {n} layers {cfg.layer_kinds()}, float32, "
        f"{what}: loss card {float(gm['loss']):.6f} CPU "
        f"{float(wm['loss']):.6f} (|diff| {loss_err:.3g}, limit 1e-5 "
        f"relative); grad norm {float(wm['grad_norm']):.6g}, |diff| "
        f"{gn_err:.3g} (limit 1e-5 relative); updated params max |card - "
        f"CPU| {worst:.3g} at {where} (limit 1e-5); step {t_card:.2f} s "
        f"card, {t_cpu:.2f} s CPU  ok")
    return {"loss_err": loss_err, "grad_norm_err": gn_err,
            "param_err": worst}


# -- the remaining model families, served (phases 23-26) ----------------------

RG_ARCH, MOE_ARCH, MLA_ARCH = ("recurrentgemma_2b", "moonshot_v1_16b_a3b",
                               "deepseek_v3_671b")
# 8 requests, one generate task of the pipeline's batch of 8
FAMILY_TEXTS, FAMILY_LO, FAMILY_HI = 8, 96, 160
# float32 decode logits against the whole-sequence forward on the same
# tokens, max |diff| over max |logit|: the two paths sum in other orders
# (the scan against the step, the whole-sequence kernel against the decode
# kernel, materialized against absorbed MLA) through up to 26 layers, about
# a thousand float32 ulps of the largest logit
FAMILY_LOGITS_REL = 2e-4
# moe_capacity (dropless) against moe_ref in float32 at full width, max
# |diff| over max |out|: the same products summed over d_model and d_expert
# in two orders (batched products against einsums)
MOE_REL = 1e-5
# moonshot's depth served in bf16 (of 48: its host-bound step scales with
# the layers it runs), and in its float32 check
MOE_SERVE_LAYERS, MOE_EXACT_LAYERS = 24, 8
MOE_TOKENS = 64           # tokens of the one-layer MoE check


def _family_prompts(cfg, n: int, seed: int, lo: int, hi: int) -> list:
    return [[ord(ch) % cfg.vocab_size for ch in x["text"]]
            for x in _texts(n, seed=seed, lo=lo, hi=hi)]


def _free() -> None:
    """Give the card back what freed models held."""
    gc.collect()
    torch.cuda.empty_cache()


def _whole_against_decode(models, cfg, params, prompts, runs, label,
                          whole_cfg=None) -> float:
    """Each request's prompt and generated tokens (the ``label`` engine's,
    ``runs`` from :func:`phase_exactness`) through one whole-sequence
    forward; the logits that chose each generated token against the decode
    step's row. Returns max |diff| over max |logit|, held to
    FAMILY_LOGITS_REL."""
    toks, rows = runs[label]
    worst, scale = 0.0, 0.0
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            rid = f"x{i}"
            seq = list(prompt) + toks[rid][:-1]
            logits, _, _ = models.forward(
                params, whole_cfg or cfg,
                {"tokens": torch.tensor([seq], device="cuda")})
            for j, row in enumerate(rows[rid]):
                whole = logits[0, len(prompt) - 1 + j, :cfg.vocab_size].cpu()
                worst = max(worst, float((whole - row[:cfg.vocab_size])
                                         .abs().max()))
                scale = max(scale, float(whole.abs().max()))
    rel = worst / scale
    assert rel <= FAMILY_LOGITS_REL, (label, worst, scale)
    log(f"  {label} decode logits against the whole-sequence forward on the "
        f"same tokens ({len(prompts)} requests x {MAX_NEW_EXACT} tokens): "
        f"max |diff| {worst:.3g}, max |logit| {scale:.3g}, relative "
        f"{rel:.3g} (limit {FAMILY_LOGITS_REL})  ok")
    return rel


def phase_family_serving(fd, models, configs, serve, KsaCluster,
                         ResourceProfile, arch, engine_kw, n_dense, n_paged,
                         plain_watch, smi, layers=None) -> dict:
    """One family's serving cell at full width in bf16 (random weights,
    seed 0; the depth cut to ``layers`` if given): FAMILY_TEXTS requests of
    FAMILY_LO-FAMILY_HI prompt tokens and MAX_NEW new ones through
    ``serve_pipeline`` on one GPU worker, with the launch counts asserted,
    beside the weights bound of a step."""
    cfg = configs.get_config(arch)
    if layers:
        cfg = cfg.with_(n_layers=layers)
    cfg, params = _serving_model(models, configs, cfg)
    texts = _texts(FAMILY_TEXTS, seed=2, lo=FAMILY_LO, hi=FAMILY_HI)
    served = phase_serving(fd, cfg, params, serve, KsaCluster,
                           ResourceProfile, texts=texts, engine_kw=engine_kw,
                           n_dense=n_dense, n_paged=n_paged,
                           plain_watch=plain_watch)
    served["bound_ms"] = bound_ms = _weights_bound_ms(cfg, params)
    log(f"  a (dropless) decode step reads every weight but the token "
        f"table and a frontend once: bound {bound_ms:.2f} ms at "
        f"{HBM_BYTES_S / 1e12:.2f} TB/s "
        f"against the median step {served['step_ms']:.2f} ms ({smi})")
    del params
    _free()
    return served


def _weights_bound_ms(cfg, params) -> float:
    """Bytes of every parameter a decode step reads (all but the token
    embedding's table, of which it gathers 8 rows, and a frontend; the
    unembedding whole), over the card's memory rate."""
    n = sum(p.numel() * p.element_size() for p in _leaves(params))
    table = params["embed"]["embedding"]
    if not cfg.tie_embeddings:
        n -= table.numel() * table.element_size()
    # a frontend (patches, frames) runs on the prompt's inputs, not a step's
    n -= sum(p.numel() * p.element_size()
             for p in _leaves(params.get("frontend", {})))
    return n / HBM_BYTES_S * 1e3


def phase_rg_exactness(fa, models, configs, serve, smi) -> dict:
    """recurrentgemma-2b at full width in float32: the flash engines' greedy
    tokens against the chunked engine's, dense at max_len 4096 (2048-row
    rings, dense flash-decode at G = 10) and paged at max_len 1024 (the
    local layers paged: the paged kernel at G = 10); then the dense flash
    engine's decode logits (rglru_step, flash-decode) against the
    whole-sequence forward (rglru_scan, the flash-attention kernel at G =
    10, window 2048) on the same tokens."""
    t0 = time.perf_counter()
    cfg, params = _serving_model(models, configs,
                                 configs.get_config(RG_ARCH).with_(
                                     dtype="float32"), torch.float32)
    prompts = _family_prompts(cfg, N_EXACT, seed=3, lo=40, hi=64)
    runs = phase_exactness(cfg, params, serve, prompts,
                           ref_kw=dict(max_len=4096), variants=(
        ("dense flash", dict(decode_kernel="flash", max_len=4096)),
        ("paged flash", dict(decode_kernel="flash", paged=True,
                             page_size=64, max_len=1024))))
    before = fa.flash_attention.launches
    rel = _whole_against_decode(models, cfg, params, prompts, runs,
                                "dense flash")
    n_local = cfg.layer_kinds().count("local")
    assert fa.flash_attention.launches - before == n_local * len(prompts)
    log(f"  the whole-sequence forwards ran flash_attention "
        f"{n_local * len(prompts)} times ({n_local} local layers x "
        f"{len(prompts)}); {time.perf_counter() - t0:.1f} s ({smi})")
    del params, runs
    _free()
    return {"logits_rel": rel}


def phase_moe_exactness(models, configs, serve, smi) -> dict:
    """moonshot-v1-16b-a3b at full width, depth cut to MOE_EXACT_LAYERS, in
    float32: the paged flash engine's greedy tokens against the chunked
    engine's; then, on one layer's full-width experts, moe_capacity
    (dropless) against moe_ref on MOE_TOKENS tokens."""
    from repro_torch.models import moe
    t0 = time.perf_counter()
    cfg, params = _serving_model(
        models, configs, configs.get_config(MOE_ARCH).with_(
            n_layers=MOE_EXACT_LAYERS, dtype="float32"), torch.float32)
    prompts = _family_prompts(cfg, N_EXACT, seed=4, lo=40, hi=64)
    phase_exactness(cfg, params, serve, prompts, variants=(
        ("paged flash", dict(decode_kernel="flash", paged=True,
                             page_size=64)),))
    ffn = params["periods"]["0"]["ffn"]
    layer = {k: (v[0] if k != "shared" else v) for k, v in ffn.items()}
    layer["shared"] = {k: v[0] for k, v in ffn["shared"].items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((MOE_TOKENS, cfg.d_model), generator=gen, device="cuda")
    with torch.no_grad():
        got, aux = moe.moe_capacity(layer, cfg, x, capacity=MOE_TOKENS)
        want, aux_ref = moe.moe_ref(layer, cfg, x)
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    assert rel <= MOE_REL and float(aux) == float(aux_ref), (err, rel)
    log(f"  moe_capacity (dropless, capacity {MOE_TOKENS}) against moe_ref "
        f"on layer 0's {cfg.moe.n_experts} full-width experts, "
        f"{MOE_TOKENS} tokens: max |diff| {err:.3g}, relative {rel:.3g} "
        f"(limit {MOE_REL}); aux equal  ok; "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    del params, layer
    _free()
    return {"moe_rel": rel}


def phase_mla(models, configs, serve, smi) -> dict:
    """deepseek-v3-671b at full width cut to one layer (MLA and the
    256-expert MoE): bf16, FAMILY_TEXTS // 2 requests through the dense
    engine (a paged engine raises, as in the reference), the step printed;
    then in float32 alone on the card, the absorbed decode's logits
    (chunked dense engine) against the materialized whole-sequence
    forward's on the same tokens. The whole-sequence forward runs the MoE
    with capacity factor E / k, so that its capacity is the token count and
    it drops nothing, as decode does."""
    import dataclasses
    base = configs.get_config(MLA_ARCH).with_(n_layers=1)
    cfg, params = _serving_model(models, configs, base)
    try:
        serve.ServeEngine(cfg, params, paged=True, n_slots=4, max_len=1024,
                          device="cuda")
        raise AssertionError("a paged MLA engine was built")
    except NotImplementedError:
        pass
    eng = serve.ServeEngine(cfg, params, n_slots=4, max_len=1024,
                            device="cuda")
    eng.run_until_drained([("warm-up", [1, 2, 3, 4, 5], 2)])
    step_s: list = []
    _timed_serve(eng, step_s, profile_at=10**9, trace={})   # no profile
    prompts = _family_prompts(cfg, FAMILY_TEXTS // 2, seed=5, lo=FAMILY_LO,
                              hi=FAMILY_HI)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = eng.run_until_drained([(f"d{i}", p, MAX_NEW)
                                 for i, p in enumerate(prompts)])
    elapsed = time.perf_counter() - t0
    assert all(len(v) == MAX_NEW for v in out.values()) and len(out) == 4
    step_ms = statistics.median(step_s) * 1e3
    peak = torch.cuda.max_memory_allocated()
    bound_ms = _weights_bound_ms(cfg, params)
    log(f"  {len(prompts)} requests of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} prompt tokens, {MAX_NEW} new each, dense "
        f"engine (4 slots, max_len 1024): {elapsed:.2f} s, {len(step_s)} "
        f"steps, median step {step_ms:.2f} ms (host clock, synchronised), "
        f"bound of a dropless step {bound_ms:.2f} ms; peak device memory "
        f"{peak / 1e9:.2f} GB; a paged engine raises NotImplementedError  "
        f"ok ({smi})")
    del params, eng
    _free()
    cfg32, p32 = _serving_model(models, configs, base.with_(dtype="float32"),
                                torch.float32)
    prompts = _family_prompts(cfg32, N_EXACT, seed=6, lo=40, hi=64)
    runs = phase_exactness(cfg32, p32, serve, prompts, variants=())
    e = cfg32.moe
    whole_cfg = cfg32.with_(moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k))
    rel = _whole_against_decode(models, cfg32, p32, prompts, runs,
                                "reference", whole_cfg=whole_cfg)
    del p32, runs
    _free()
    return {"step_ms": step_ms, "steps": len(step_s), "peak_bytes": peak,
            "bound_ms": bound_ms, "logits_rel": rel, "elapsed_s": elapsed}


# -- the federation, and the encoder and VLM families (phases 27-29) ----------

HUBERT_ARCH, VLM_ARCH = "hubert_xlarge", "internvl2_1b"
# the prefill_32k cell's sequence, its batch cut from 32 to 1
ENC_BATCH, ENC_SEQ, ENC_RUNS = 1, 32768, 3
# the train_4k cell's sequence, its batch cut from 256 to two, as phase 21
FAMILY_TRAIN = dict(batch=2, seq=4096)
TRAIN_STEPS = 3                     # timed, after one warm-up step
EXACT_TRAIN = dict(batch=2, seq=768)  # the float32 card-against-CPU step
VLM_EXACT_LAYERS = 4                # internvl2-1b's depth in its token check


def model_ops(cfg, params, b: int, s_text: int, n_prefix: int = 0,
              train: bool = False) -> float:
    """Operations of one forward over b sequences of n_prefix frontend
    positions (patches) and s_text positions, or of a train step (train):
    every weight product at 2 operations a weight a position (the layers'
    on every position; the frontend's on its inputs: every frame of an
    audio model, the patches of a VLM; the unembedding's on the text), the
    attention products over the live (query head, key) pairs as
    attention_bound counts them (4 D forward, 10 D backward); an SSD
    layer's scan is not counted. A backward doubles the weight products
    (input and weight gradients)."""
    def weights(tree) -> int:
        return sum(weights(v) if isinstance(v, dict) else v.numel()
                   for k, v in tree.items()
                   if isinstance(v, dict) or k.startswith("w"))
    s = n_prefix + s_text
    emb = params["embed"]
    unembed = emb["unembed"] if "unembed" in emb else emb["embedding"]
    front = params.get("frontend")
    front_pos = (0 if front is None else b * s if cfg.frontend.kind
                 == "audio_frames" else b * n_prefix)
    products = 2 * (b * s * (weights(params.get("periods", {}))
                             + weights(params.get("tail", {})))
                    + b * s_text * unembed.numel()
                    + front_pos * (front["w"].numel() if front else 0))
    attn = 0
    for kind in cfg.layer_kinds():
        if kind == "ssd":
            continue
        window = cfg.window_size if kind == "local" else None
        for backward in ((False, True) if train else (False,)):
            attn += attention_bound(b, s, s, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim, not cfg.encoder_only,
                                    window, 2, backward=backward)[2]["ops"]
    return products * (3 if train else 1) + attn


def phase_train_steps(label, cfg, run, counted, train_step_mod, trainer,
                      data, plain_watch, smi, n_prefix: int = 0,
                      remat: str = "none") -> dict:
    """TRAIN_STEPS make_train_step steps (``remat`` as given) at full width
    on the card, outside any campaign: a fresh state (bf16 params, fp32
    master, AdamW; seed 0),
    one warm-up step, then TRAIN_STEPS steps with every count of
    ``counted`` (name: (wrapper, attribute, launches a step)) set to 0 just
    before them and read just after, no plain version on a CUDA tensor
    (``plain_watch``) and finite losses; then PROFILE_TRAIN_STEPS steps
    under torch.profiler. The median step beside the operations bound."""
    ocfg = trainer._ocfg_from_params({})
    torch.cuda.reset_peak_memory_stats()
    state = train_step_mod.init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = train_step_mod.make_train_step(cfg, ocfg, remat=remat)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(
        cfg, 0, s, batch=run["batch"], seq=run["seq"]).items()}
        for s in range(1 + TRAIN_STEPS + PROFILE_TRAIN_STEPS)]
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    times, losses = [], []
    with plain_watch as plain:
        for fn, attr, _ in counted.values():
            setattr(fn, attr, 0)           # count only these steps
        for b in batches[1:1 + TRAIN_STEPS]:
            t0 = time.perf_counter()
            state, metrics = step(state, b)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
        launches = {name: getattr(fn, attr)
                    for name, (fn, attr, _) in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), losses
    for name, (_, _, per_step) in counted.items():
        assert launches[name] == per_step * TRAIN_STEPS, \
            f"{launches[name]} {name} launches, expected {per_step} x " \
            f"{TRAIN_STEPS}"
    assert not plain, f"plain versions ran on the card: {plain}"
    # the steps rebind ``state`` here, so no older train state stays alive
    # beside the new one (at the gemma3 step's peak, 14 GB more would not
    # fit the card)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        for b in batches[1 + TRAIN_STEPS:]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    share = _device_share({"prof": prof, "wall": wall}, PROFILE_TRAIN_STEPS)
    ops = model_ops(cfg, state.params, run["batch"], run["seq"], n_prefix,
                    train=True)
    del state, batches
    _free()
    step_ms = statistics.median(times) * 1e3
    tokens = run["batch"] * run["seq"]
    bound_ms = ops / BF16_FLOP_S * 1e3
    log(f"  {label}: {_describe(cfg, run)}"
        + (f" (+ {n_prefix} patches a sequence)" if n_prefix else "")
        + (f", remat={remat!r}" if remat != "none" else ""))
    log(f"  {TRAIN_STEPS} steps after a warm-up: median {step_ms:.2f} ms "
        f"(host clock, synchronised; {[round(x * 1e3, 2) for x in times]}), "
        f"{tokens * 1e3 / step_ms:.0f} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; launches "
        + ", ".join(f"{n} {launches[n]} = {per} x {TRAIN_STEPS}"
                    for n, (_, _, per) in counted.items())
        + "; no plain-version call on a CUDA tensor  ok")
    log(f"  device memory: {held / 1e9:.2f} GB held after the warm-up, peak "
        f"{peak / 1e9:.2f} GB; operations bound {ops:.4g} a step, "
        f"{bound_ms:.2f} ms at {BF16_FLOP_S / 1e12:.0f} TFLOP/s "
        f"({bound_ms / step_ms:.1%} of the median step) ({smi})")
    if share is None or share["busy"] is None:
        log("  torch.profiler: no device time recorded (not measured)")
    else:
        log(f"  torch.profiler over {PROFILE_TRAIN_STEPS} steps: "
            f"{share['device_ms_per_step']:.2f} ms of device time and "
            f"{share['kernels']:.0f} kernels a step (busy "
            f"{share['busy']:.1%}); device ms a step by kernel:")
        for name, ms in share["top"]:
            log(f"    {ms:8.4f}  {name[:90]}")
        mine = [(re.search(r"\w+_kernel", n).group(0), ms)
                for n, ms in share["by_kernel"]
                if re.search(r"(ssd|flash)_\w+_kernel", n)]
        log("  the port's kernels, device ms a step: " + (", ".join(
            f"{n} {ms:.4f}" for n, ms in mine) or "none recorded"))
    return {"step_ms": step_ms, "tokens_per_s": tokens * 1e3 / step_ms,
            "losses": losses, "launches": launches, "peak_bytes": peak,
            "held_bytes": held, "bound_ms": bound_ms, "ops": ops,
            "device_ms_per_step": share and share.get("device_ms_per_step"),
            "kernels_per_step": share and share.get("kernels")}


def _fa_counted(fa, layers: int) -> dict:
    return {"flash_attention": (fa.flash_attention, "launches", layers),
            "flash_attention_bwd": (fa.flash_attention, "bwd_launches",
                                    layers)}


def phase_federation(knots, writhe, flat: dict, smi) -> dict:
    """Phase 6's campaign on the paper's deployment: a FederatedCluster of
    a home site ``edge`` (CPU workers) and a remote site ``hpc`` (CPU
    workers and one GPU worker) behind a modeled WAN link, the localize
    stage pinned to ``hpc`` and routed there to the GPU class, the screen
    spilling to ``hpc`` on backlog (examples/knot_campaign.py's knobs).
    Results equal phase 6's; every localize task relayed by a bridge and
    run on the ``hpc`` GPU worker."""
    from repro_torch.federation import (FederatedCluster, Site,
                                        SpilloverConfig, WanLink)
    session = {"session_timeout_s": SESSION_TIMEOUT_S}
    sites = [Site("edge", workers=2, worker_slots=1, cluster_kw=session),
             Site("hpc", workers=1, worker_slots=2, gpu_workers=1,
                  spinup_s=0.5, slot_cost=1.5,
                  link=WanLink(latency_s=0.01, bandwidth_mbps=500.0),
                  cluster_kw=session)]
    spill = SpilloverConfig(classes=("cpu",), horizon_s=0.3, min_backlog=2,
                            interval_s=0.05, cooldown_s=0.2,
                            drain_idle_s=0.5, bridge_slots=2,
                            max_bridges_per_class=2)
    ids = list(range(CAMPAIGN))
    with FederatedCluster(sites, prefix="fedknots", http=True,
                          spillover=spill) as fed:
        spec = knots.knots_pipeline(B_FULL, n_points=N_POINTS,
                                    gpu_localize=True, localize_site="hpc")
        writhe.writhe_map.launches = 0     # count only this path's run
        res = fed.run_campaign(spec, ids, timeout_s=CAMPAIGN_TIMEOUT_S)
        launches = writhe.writhe_map.launches
        assert res.status.state == "COMPLETED", res.status.state
        agg = res.final
        hpc = fed.clusters["hpc"]
        gpu_ids = {a.agent_id for a in hpc.agents
                   if a.profile is not None and a.profile.gpus}
        locs = sorted(t for t in fed.home.monitor.tasks() if "localize" in t)
        for tid in locs:
            home, remote = fed.task(tid), hpc.task(tid)
            assert home.done and home.agent_id.startswith("bridge-hpc-"), \
                (tid, home.agent_id)
            assert remote is not None and remote.done, tid
            assert remote.agent_id in gpu_ids, (tid, remote.agent_id)
        screens = [r for r in res.results["screen"] if r]
        loc_res = [r for r in res.results.get("localize", []) if r]
        with_work = (sum(1 for r in screens if r["kept"])
                     + sum(1 for r in loc_res if r["candidates"]))
        assert locs and launches >= with_work > 0, (locs, launches,
                                                    with_work)
        text = fed.metrics_text()
        assert 'site="edge"' in text and 'site="hpc"' in text
        rep = fed.campaign_report(res.campaign_id)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fed.http_port}/sites") as r:
            payload = json.loads(r.read())
        relayed = {f"{b.agent_id} ({b.role})": b.tasks_completed
                   for b in fed.bridges()}
    want = flat["final"]
    for key in ("processed", "kept", "knotted", "cores"):
        assert agg[key] == want[key], key
    log(f"  campaign: {CAMPAIGN} structures in {res.elapsed_s:.2f} s "
        f"({CAMPAIGN / res.elapsed_s:.1f} structures/s; phase 6, one "
        f"site: {flat['elapsed_s']:.2f} s, "
        f"{CAMPAIGN / flat['elapsed_s']:.1f} structures/s); kept "
        f"{agg['kept']}, knotted {len(agg['knotted'])}, cores "
        f"{len(agg['cores'])}, batches {agg['batches']}, mean ACN "
        f"{agg['mean_acn']:.4f}: processed, kept, knotted and cores equal "
        f"to phase 6's  ok")
    for name, s in rep["stages"].items():
        log(f"    stage {name:>9}: {s['tasks']} tasks, queue "
            f"{s['queue_s']:.2f} s, run {s['run_s']:.2f} s, wall "
            f"{s['wall_s']:.2f} s")
    log(f"  {len(locs)} localize tasks, each completed at home by a "
        f"bridge-hpc- relay and done in the hpc monitor on its GPU worker "
        f"{sorted(gpu_ids)}  ok; tasks relayed by bridge {relayed}")
    log(f"  /sites, completed leases by site: "
        + ", ".join(f"{n} {s['leases']['completed']}"
                    for n, s in payload["sites"].items())
        + f"; writhe launches {launches} (tasks with work {with_work}); "
        f"metrics_text() carries site=\"edge\" and site=\"hpc\" samples  ok "
        f"({smi})")
    return {"launches": launches, "makespan_s": res.elapsed_s,
            "structures_per_s": CAMPAIGN / res.elapsed_s,
            "flat_makespan_s": flat["elapsed_s"], "relayed": relayed,
            "localize_tasks": len(locs),
            "completed_leases": {n: s["leases"]["completed"]
                                 for n, s in payload["sites"].items()}}


def phase_encoder(fa, models, configs, train_step_mod, plain_watch, smi
                  ) -> dict:
    """hubert-xlarge at full width and depth in bf16 (random weights, seed
    0): ENC_RUNS calls of make_prefill_step (the encoder's serving path)
    on ENC_BATCH x ENC_SEQ frames, each launching the flash-attention
    forward once a layer and no plain version on the card; finite logits of
    the right shape; the median call beside the operations bound."""
    cfg, params = _serving_model(models, configs,
                                 configs.get_config(HUBERT_ARCH))
    prefill = train_step_mod.make_prefill_step(cfg)
    gen = torch.Generator(device="cuda").manual_seed(7)
    frames = torch.randn((ENC_BATCH, ENC_SEQ, cfg.frontend.input_dim),
                         generator=gen, device="cuda")
    prefill(params, {"embeds": frames[:, :1024]})      # first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    with plain_watch as plain:
        fa.flash_attention.launches = 0    # count only these calls
        for _ in range(ENC_RUNS):
            t0 = time.perf_counter()
            logits = prefill(params, {"embeds": frames})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = fa.flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    assert launches == cfg.n_layers * ENC_RUNS, launches
    assert not plain, f"plain versions ran on the card: {plain}"
    assert logits.shape == (ENC_BATCH, ENC_SEQ, cfg.padded_vocab), \
        logits.shape
    assert bool(torch.isfinite(logits).all()), "non-finite logits"
    ops = model_ops(cfg, params, ENC_BATCH, ENC_SEQ)
    bound_ms = ops / BF16_FLOP_S * 1e3
    ms = statistics.median(times) * 1e3
    log(f"  make_prefill_step on {ENC_BATCH} x {ENC_SEQ} frames of "
        f"{cfg.frontend.input_dim}: median {ms:.2f} ms over {ENC_RUNS} "
        f"calls (host clock, synchronised; "
        f"{[round(x * 1e3, 2) for x in times]}), "
        f"{ENC_BATCH * ENC_SEQ * 1e3 / ms:.0f} frames/s; flash_attention "
        f"{launches} = {cfg.n_layers} x {ENC_RUNS}; no plain version on the "
        f"card; logits {tuple(logits.shape)} finite  ok")
    log(f"  peak device memory {peak / 1e9:.2f} GB; operations bound "
        f"{ops:.4g}, {bound_ms:.2f} ms at {BF16_FLOP_S / 1e12:.0f} TFLOP/s "
        f"({bound_ms / ms:.1%} of the median call) ({smi})")
    del params, logits, frames
    _free()
    return {"prefill_ms": ms, "prefill_launches": launches,
            "prefill_peak_bytes": peak, "prefill_bound_ms": bound_ms,
            "prefill_ops": ops}


def phase_family_train(fa, configs, train_step_mod, trainer, data, optim,
                       tree, arch, plain_watch, smi) -> dict:
    """``arch`` trained at full width and depth (phase_train_steps at
    FAMILY_TRAIN, the flash-attention kernels once a layer each way), then
    one float32 step at full width cut to 2 layers on the card and on the
    CPU (EXACT_TRAIN)."""
    cfg = configs.get_config(arch)
    n_prefix = cfg.frontend.n_positions \
        if cfg.frontend is not None and cfg.frontend.kind == "vit_patches" \
        else 0
    trained = phase_train_steps(
        f"{cfg.name} at full width and depth", cfg, FAMILY_TRAIN,
        _fa_counted(fa, cfg.n_layers), train_step_mod, trainer, data,
        plain_watch, smi, n_prefix)
    cfg32 = cfg.with_(n_layers=2, dtype="float32")
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(
        cfg32, 1, 0, **EXACT_TRAIN).items()}
    trained["exact"] = _train_step_card_vs_cpu(
        fa, train_step_mod, optim, tree, cfg32, batch,
        f"batch {EXACT_TRAIN['batch']} x {EXACT_TRAIN['seq']}"
        + (f" (+ {n_prefix} patches)" if n_prefix else ""))
    _free()
    return trained


def phase_vlm_exactness(models, configs, serve, smi) -> dict:
    """internvl2-1b at full width cut to VLM_EXACT_LAYERS in float32: the
    dense and paged flash engines' greedy tokens (flash-decode at G = 7, D =
    64) equal to the chunked engine's."""
    t0 = time.perf_counter()
    cfg, params = _serving_model(
        models, configs, configs.get_config(VLM_ARCH).with_(
            n_layers=VLM_EXACT_LAYERS, dtype="float32"), torch.float32)
    prompts = _family_prompts(cfg, N_EXACT, seed=8, lo=40, hi=64)
    phase_exactness(cfg, params, serve, prompts)
    log(f"  {VLM_EXACT_LAYERS}-layer float32 check: "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    del params
    _free()
    return {"tokens_equal": True}



# -- remat and the sharded train step (phases 30-31) -------------------------

REMAT_POLICIES = ("full", "dots", "dots_no_batch")
REMAT_EXACT = dict(layers=6, batch=2, seq=1024)   # one full gemma3 period
# the sharded step's float32 parity (world of one): mamba2-130m at full
# width and depth, moonshot-v1-16b-a3b at full width cut to 1 layer
SHARD_EXACT = {TRAIN_ARCH: dict(layers=None, batch=2, seq=1024),
               "moonshot_v1_16b_a3b": dict(layers=1, batch=2, seq=512)}
SHARD_BF16_REL = 1e-5   # the sharded bf16 losses against the unsharded


def remat_launches(cfg, kind_of: tuple, remat: str) -> int:
    """Forward launches a train step makes of the kernel that the layers
    of the kinds ``kind_of`` run: once a layer, and once more in the
    backward for each such layer inside a checkpointed period (the tail is
    not checkpointed)."""
    in_periods = sum(k in kind_of for k in cfg.layer_pattern) * cfg.n_periods
    tail = sum(k in kind_of for k in cfg.layer_pattern[:cfg.n_remainder])
    return (2 if remat != "none" else 1) * in_periods + tail


def _exact_opt(optim):
    # eps as in tests/test_torch_train.py and phase 17
    return optim.OptimizerConfig(lr=1e-3, eps=1e-5, warmup_steps=0,
                                 schedule="constant", weight_decay=0.1)


def _param_diff(tree, got, want) -> tuple[float, str, bool]:
    """(max |got - want| over the params, where, every leaf bit-equal),
    compared on ``got``'s device a leaf at a time."""
    worst, where, equal = 0.0, "", True
    for (name, g), w in zip(tree.paths(got), tree.leaves(want)):
        g, w = g.detach(), w.detach().to(g.device)
        equal = equal and torch.equal(g, w)
        e = float((g.float() - w.float()).abs().max())
        if e > worst:
            worst, where = e, name
    return worst, where, equal


def phase_remat_exactness(fa, train_step_mod, configs, optim, tree, data,
                          smi) -> dict:
    """gemma3-1b at full width cut to one period (6 layers), float32, one
    train step on the card under each remat policy against the step
    without: loss and params within 1e-5, and whether bit-equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config(ATTN_ARCH).with_(
        n_layers=REMAT_EXACT["layers"], dtype="float32")
    ocfg = _exact_opt(optim)
    state = train_step_mod.init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(
        cfg, 1, 0, batch=REMAT_EXACT["batch"],
        seq=REMAT_EXACT["seq"]).items()}
    want, wm = train_step_mod.make_train_step(cfg, ocfg)(state, batch)
    out = {}
    for policy in REMAT_POLICIES:
        before = fa.flash_attention.launches
        got, gm = train_step_mod.make_train_step(cfg, ocfg, remat=policy)(
            state, batch)
        torch.cuda.synchronize()
        fwd = fa.flash_attention.launches - before
        assert fwd == remat_launches(cfg, ("attn", "local"), policy), fwd
        loss_err = abs(float(gm["loss"]) - float(wm["loss"]))
        worst, where, equal = _param_diff(tree, got.params, want.params)
        equal = equal and float(gm["loss"]) == float(wm["loss"])
        assert loss_err <= 1e-5 * abs(float(wm["loss"])), loss_err
        assert worst <= 1e-5, (policy, worst, where)
        log(f"  remat={policy!r}: loss {float(gm['loss']):.6f} against "
            f"{float(wm['loss']):.6f} (|diff| {loss_err:.3g}), params max "
            f"|diff| {worst:.3g}{f' at {where}' if worst else ''} (limits "
            f"1e-5); {'bit-equal' if equal else 'not bit-equal'}; {fwd} "
            f"forward flash-attention launches  ok")
        out[policy] = {"loss_err": loss_err, "param_err": worst,
                       "bit_equal": equal, "fwd_launches": fwd}
        del got
    del state, want
    _free()
    log(f"  {cfg.name} cut to {cfg.n_layers} layers (one period), float32, "
        f"batch {REMAT_EXACT['batch']} x {REMAT_EXACT['seq']} ({smi})")
    return out


def phase_remat(fa, ssd, configs, train_step_mod, trainer, data, optim, tree,
                plain_targets, attn_step, mamba_step, smi) -> dict:
    """The gemma3-1b step of phase 21 (26 layers, 2 x 4096, bf16) and the
    mamba2-130m step of phase 15 (24 layers, 8 x 2048) under
    remat="full", each beside the same run's step without remat; then the
    float32 policy checks."""
    no_ssd = {"ssd_scan": (ssd.ssd_scan, "launches", 0),
              "ssd_scan_bwd": (ssd.ssd_scan, "bwd_launches", 0)}
    gcfg = configs.get_config(ATTN_ARCH)
    g_fwd = remat_launches(gcfg, ("attn", "local"), "full")
    gem = phase_train_steps(
        f"{gcfg.name} at full width and depth, remat", gcfg, ATTN_TRAIN,
        {"flash_attention": (fa.flash_attention, "launches", g_fwd),
         "flash_attention_bwd": (fa.flash_attention, "bwd_launches",
                                 gcfg.n_layers), **no_ssd},
        train_step_mod, trainer, data, plain_calls_on_card(plain_targets),
        smi, remat="full")
    mcfg = configs.get_config(TRAIN_ARCH)
    m_fwd = remat_launches(mcfg, ("ssd",), "full")
    mam = phase_train_steps(
        f"{mcfg.name} at full width and depth, remat", mcfg, TRAIN,
        {"ssd_scan": (ssd.ssd_scan, "launches", m_fwd),
         "ssd_scan_bwd": (ssd.ssd_scan, "bwd_launches", mcfg.n_layers),
         "flash_attention": (fa.flash_attention, "launches", 0)},
        train_step_mod, trainer, data, plain_calls_on_card(plain_targets),
        smi, remat="full")
    for name, on, off in ((gcfg.name, gem, attn_step),
                          (mcfg.name, mam, mamba_step)):
        log(f"  {name}: remat='full' median {on['step_ms']:.2f} ms against "
            f"{off['step_ms']:.2f} ms without ({on['step_ms'] / off['step_ms']:.3f}"
            f"x); peak {on['peak_bytes'] / 1e9:.2f} GB against "
            f"{off['peak_bytes'] / 1e9:.2f} GB, held "
            f"{on['held_bytes'] / 1e9:.2f} GB against "
            f"{off['held_bytes'] / 1e9:.2f} GB; kernels a step "
            f"{on['kernels_per_step']} against {off['kernels_per_step']} "
            f"({smi})")
    exact = phase_remat_exactness(fa, train_step_mod, configs, optim, tree,
                                  data, smi)
    return {ATTN_ARCH: gem, TRAIN_ARCH: mam, "exact": exact}


def _sharded_exact(dist, arch, run, fa, ssd, configs, train_step_mod,
                   optim, tree, data, plain_targets, smi) -> dict:
    """One float32 step of ``arch`` (full width, ``run['layers']`` layers
    or all) sharded by ``dist`` against the unsharded step on the card,
    from the same state: loss and params within 1e-5; every kernel of the
    path launched once a layer each way, no plain version on the card.
    Only the unsharded step's loss and params (on the host) are kept while
    the sharded step runs."""
    cfg = configs.get_config(arch)
    if run["layers"]:
        cfg = cfg.with_(n_layers=run["layers"])
    cfg = cfg.with_(dtype="float32")
    ocfg = _exact_opt(optim)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.batch_at(
        cfg, 1, 0, batch=run["batch"], seq=run["seq"]).items()}
    n_attn = sum(k in ("attn", "local") for k in cfg.layer_kinds())
    n_ssd = cfg.layer_kinds().count("ssd")
    counts = ((fa.flash_attention, "launches", n_attn),
              (fa.flash_attention, "bwd_launches", n_attn),
              (ssd.ssd_scan, "launches", n_ssd),
              (ssd.ssd_scan, "bwd_launches", n_ssd))
    state = train_step_mod.init_train_state(
        cfg, ocfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    new, m = train_step_mod.make_train_step(cfg, ocfg)(state, batch)
    want_loss = float(m["loss"])
    want = tree.tree_map(lambda t: t.cpu(), new.params)
    del new, m
    sharded = train_step_mod.shard_train_state(state, cfg, ocfg, dist)
    del state
    _free()
    step = train_step_mod.make_train_step(cfg, ocfg, dist=dist)
    with plain_calls_on_card(plain_targets) as plain:
        for fn, attr, _ in counts:
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        new, m = step(sharded, dist.shard_batch(batch))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [getattr(fn, attr) for fn, attr, _ in counts]
    assert launches == [n for _, _, n in counts], launches
    assert not plain, f"plain versions ran on the card: {plain}"
    loss_err = abs(float(m["loss"]) - want_loss)
    got = dist.gather(new.params)
    worst, where, equal = _param_diff(tree, got, want)
    del new, sharded, got
    _free()
    assert loss_err <= 1e-5 * abs(want_loss), loss_err
    assert worst <= 1e-5, (worst, where)
    log(f"  {cfg.name}, {cfg.n_layers} layers, float32, batch "
        f"{run['batch']} x {run['seq']}: sharded loss {float(m['loss']):.6f}"
        f" against {want_loss:.6f} (|diff| {loss_err:.3g}), params max "
        f"|diff| {worst:.3g} (limits 1e-5; "
        f"{'bit-equal' if equal else 'not bit-equal'}); launches "
        f"flash_attention {launches[0]} + {launches[1]}, ssd_scan "
        f"{launches[2]} + {launches[3]}; no plain version on the card; step "
        f"{wall:.2f} s  ok")
    return {"loss_err": loss_err, "param_err": worst, "bit_equal": equal,
            "launches": dict(zip(("flash_attention", "flash_attention_bwd",
                                  "ssd_scan", "ssd_scan_bwd"), launches))}


def _sharded_timed(dist, ssd, fa, configs, train_step_mod, trainer, data,
                   tree, plain_targets) -> dict:
    """mamba2-130m at full width and depth in bf16 (phase 15's 8 x 2048;
    bf16 params, a float32 master): the unsharded and the sharded step,
    each from the same fresh state (seed 0), one warm-up and TRAIN_STEPS
    timed steps each, medians on the host clock (synchronised). On a world
    of one the sharded step runs the unsharded step's operations, so every
    sharded loss is held to the unsharded one within SHARD_BF16_REL (a
    float32 rounding difference in a gradient grows, through the bf16
    params rounded from the master, to about 1e-4 of the loss after one
    step); the params after the last step are compared too."""
    cfg = configs.get_config(TRAIN_ARCH)
    ocfg = trainer._ocfg_from_params({})
    n = cfg.n_layers
    batches = [{k: torch.from_numpy(v).cuda() for k, v in data.batch_at(
        cfg, 0, s, batch=TRAIN["batch"], seq=TRAIN["seq"]).items()}
        for s in range(1 + TRAIN_STEPS)]
    out = {}
    for name in ("unsharded", "sharded"):
        state = train_step_mod.init_train_state(
            cfg, ocfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        if name == "sharded":
            state = train_step_mod.shard_train_state(state, cfg, ocfg, dist)
            step = train_step_mod.make_train_step(cfg, ocfg, dist=dist)
            feed = [dist.shard_batch(b) for b in batches]
        else:
            step = train_step_mod.make_train_step(cfg, ocfg)
            feed = batches
        state, _ = step(state, feed[0])
        torch.cuda.synchronize()
        times, losses = [], []
        with plain_calls_on_card(plain_targets) as plain:
            ssd.ssd_scan.launches = ssd.ssd_scan.bwd_launches = 0
            for b in feed[1:]:
                t0 = time.perf_counter()
                state, m = step(state, b)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(float(m["loss"]))
            launches = (ssd.ssd_scan.launches, ssd.ssd_scan.bwd_launches)
        assert launches == (n * TRAIN_STEPS, n * TRAIN_STEPS), launches
        assert not plain, f"plain versions ran on the card: {plain}"
        assert all(np.isfinite(losses)), losses
        out[name] = {"step_ms": statistics.median(times) * 1e3,
                     "times_ms": [t * 1e3 for t in times], "losses": losses,
                     "launches": {"ssd_scan": launches[0],
                                  "ssd_scan_bwd": launches[1]}}
        if name == "unsharded":
            want = tree.tree_map(lambda t: t.cpu(), state.params)
        else:
            worst, where, equal = _param_diff(
                tree, dist.gather(state.params), want)
            rel = [abs(a - b) / abs(b) for a, b in
                   zip(losses, out["unsharded"]["losses"])]
            out[name].update(loss_rel=max(rel), param_err=worst,
                             bit_equal=equal and rel == [0.0] * len(rel))
            assert max(rel) <= SHARD_BF16_REL, (losses,
                                                out["unsharded"]["losses"])
        del state
        _free()
    del batches, want
    _free()
    return out


def phase_sharded(fa, ssd, configs, train_step_mod, trainer, data, optim,
                  tree, plain_targets, smi) -> dict:
    """The sharded train step on a world of one process (NCCL from an
    in-memory store, a (data=1, model=1) mesh): the float32 parity of
    SHARD_EXACT, then the bf16 timing beside the unsharded step."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.sharding import DistContext
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        dist = DistContext(make_smoke_mesh(1, 1, device_type="cuda"))
        out = {arch: _sharded_exact(dist, arch, run, fa, ssd, configs,
                                    train_step_mod, optim, tree, data,
                                    plain_targets, smi)
               for arch, run in SHARD_EXACT.items()}
        timed = _sharded_timed(dist, ssd, fa, configs, train_step_mod,
                               trainer, data, tree, plain_targets)
    finally:
        tdist.destroy_process_group()
    u, s_ = timed["unsharded"], timed["sharded"]
    log(f"  {TRAIN_ARCH} at full width and depth, bf16, "
        f"{TRAIN['batch']} x {TRAIN['seq']}: sharded median "
        f"{s_['step_ms']:.2f} ms ({[round(x, 2) for x in s_['times_ms']]}) "
        f"against {u['step_ms']:.2f} ms unsharded "
        f"({[round(x, 2) for x in u['times_ms']]}): DTensor's host overhead "
        f"{s_['step_ms'] - u['step_ms']:.2f} ms a step; ssd_scan "
        f"{s_['launches']['ssd_scan']} + {s_['launches']['ssd_scan_bwd']} "
        f"over {TRAIN_STEPS} sharded steps; no plain version on the card; "
        f"losses {[round(x, 6) for x in s_['losses']]} sharded, "
        f"{[round(x, 6) for x in u['losses']]} unsharded, from the same "
        f"state: max relative |diff| {s_['loss_rel']:.3g} (limit "
        f"{SHARD_BF16_REL:g}), params after the last step max |diff| "
        f"{s_['param_err']:.3g} "
        f"({'bit-equal' if s_['bit_equal'] else 'not bit-equal'}) ({smi})  ok")
    out["timed"] = timed
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {Path(__file__).name}; "
              f"run it from a checkout of the repository", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--train-step"] and len(sys.argv) == 3:
        torch.cuda.set_device(0)
        print(json.dumps(train_step_reading(Path(sys.argv[2]))), flush=True)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    if sys.argv[1:2] == ["--train-against"] and len(sys.argv) == 3:
        torch.cuda.set_device(0)
        smi = nvidia_smi()
        log(f"== the {TRAIN_ARCH} train step: other, this, this, other "
            f"({smi})")
        print(json.dumps(train_against(Path(sys.argv[2]), smi)))
        print(smi, flush=True)
        return 0
    if sys.argv[1:2] == ["--against"] and len(sys.argv) == 3:
        import _flash_decode_cases as fdc
        from repro_torch.apps import knots
        from repro_torch.kernels import build, writhe
        from repro_torch.kernels import flash_decode as fd
        torch.cuda.set_device(0)
        smi = nvidia_smi()
        print(json.dumps(compare_against(Path(sys.argv[2]), fd, build, fdc,
                                         writhe, knots, smi)))
        print(smi, flush=True)
        return 0
    if sys.argv[1:]:
        print(f"usage: {Path(__file__).name} [--against CHECKOUT | "
              f"--train-against CHECKOUT]", file=sys.stderr)
        return 2
    import _flash_attention_cases as fc
    import _flash_decode_cases as fdc
    import _ssd_cases as sc
    from repro_torch import (checkpoint, configs, data, models, optim, serve,
                             tree)
    from repro_torch.train import step as train_step_mod
    from repro_torch.train import trainer
    from repro_torch.apps import knots
    from repro_torch.cluster import KsaCluster
    from repro_torch.core import ResourceProfile
    from repro_torch.kernels import build, writhe
    from repro_torch.models import attention as attention_mod
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd

    torch.cuda.set_device(0)
    t_start = time.perf_counter()
    faulthandler.dump_traceback_later(WATCHDOG_S - (t_start - T_START),
                                      exit=True)
    log("== 1. environment")
    smi = phase_environment(build)
    with ThreadPoolExecutor(max_workers=4) as pool:
        log("== 2. build")
        pending = phase_build(build, writhe, pool)
        log("== 3. kernel against its plain version on the card")
        check_err = phase_check(knots, writhe)
        phase_parity(knots, writhe)
        log(f"== 4. timing at ({B_FULL}, {N_POINTS}, 3)")
        timing = phase_timing(knots, writhe)
        torch.cuda.empty_cache()
        log("== 5. breakdown of one batch")
        peaks = phase_breakdown(knots, writhe)
        torch.cuda.empty_cache()
        log(f"== 6. main path: KsaCluster.run_campaign, {CAMPAIGN} structures")
        knots6 = phase_main_path(knots, writhe, KsaCluster)
        torch.cuda.empty_cache()
        t_serve = time.perf_counter()
        log("== 7. build of the flash-decode kernels")
        phase_flash_build(fd, pending["flash_decode"])
    log("== 8. flash-decode kernels against their plain versions on the card")
    fd_err = phase_flash_check(fd, fdc)
    log("== 9. flash-decode timing (median, CUDA events, L2 flushed, "
        "queued)")
    fd_time = phase_flash_timing(fd, fdc)
    log(f"== 10. serving main path: KsaCluster.run_campaign(serve_pipeline), "
        f"{SERVE_ARCH} at full width cut to {SERVE_LAYERS} layers")
    cfg, params = _serving_model(models, configs, configs.get_config(
        SERVE_ARCH).with_(n_layers=SERVE_LAYERS))
    served = phase_serving(fd, cfg, params, serve, KsaCluster,
                           ResourceProfile)
    log(f"== 11. exactness at full width in float32, cut to "
        f"{EXACT_SERVE_LAYERS} layers")
    phase_exactness(*_first_layers(cfg, params, EXACT_SERVE_LAYERS), serve)
    del params
    torch.cuda.empty_cache()
    t_train = time.perf_counter()
    log("== 12. build of the SSD-scan kernels")
    phase_ssd_build(ssd, pending["ssd"])
    log("== 13. SSD-scan kernels against their plain versions on the card")
    ssd_err = phase_ssd_check(ssd, sc)
    ssd_bwd_err = phase_ssd_bwd_check(ssd, sc)
    log("== 14. SSD-scan timing at the training shape (median, CUDA events, "
        "L2 flushed)")
    ssd_time = phase_ssd_timing(ssd)
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    record = _instrument_training(trainer, checkpoint)
    n_ssd = configs.get_config(TRAIN_ARCH).layer_kinds().count("ssd")
    ssd_counted = {"ssd_scan": (ssd.ssd_scan, "launches", n_ssd),
                   "ssd_scan_bwd": (ssd.ssd_scan, "bwd_launches", n_ssd)}
    plain_targets = ([(fa, n) for n in FA_PLAIN] + [(ssd, n) for n in SSD_PLAIN]
                     + [(attention_mod, "chunked_attention")])
    try:
        log(f"== 15. training main path: TrainCampaign on KsaCluster, "
            f"{TRAIN_ARCH} at full width, {TRAIN['total_steps']} steps")
        trained = phase_training(
            TRAIN, {**ssd_counted,
                    "flash_attention": (fa.flash_attention, "launches", 0)},
            trainer, train_step_mod, checkpoint, data, configs, KsaCluster,
            ResourceProfile, record, workdir / "run1",
            plain_watch=plain_calls_on_card(plain_targets))
        train_cfg = configs.get_config(TRAIN_ARCH)
        trained["traced"] = phase_train_steps(
            f"{train_cfg.name} at full width, the campaign's step", train_cfg,
            TRAIN, {**ssd_counted,
                    "flash_attention": (fa.flash_attention, "launches", 0)},
            train_step_mod, trainer, data, plain_calls_on_card(plain_targets),
            smi)
        log("== 16. recovery at full width: an agent crashed mid-chunk")
        recovered = phase_recovery(trainer, checkpoint, KsaCluster,
                                   ResourceProfile, workdir, ssd_counted,
                                   record, plain_calls_on_card(plain_targets))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log("== 17. one train step on the card and on the CPU, float32")
    phase_train_exactness(ssd, train_step_mod, configs, optim, tree)
    torch.cuda.empty_cache()
    t_attn = time.perf_counter()
    log("== 18. build of the flash-attention kernel")
    phase_fa_build(fa, pending["flash_attention"])
    log("== 19. flash-attention kernel against its plain version on the card")
    fa_err = phase_fa_check(fa, fc)
    log("== 20. flash-attention timing (median, CUDA events, L2 flushed)")
    fa_time = phase_fa_timing(fa, fc)
    no_ssd = {"ssd_scan": (ssd.ssd_scan, "launches", 0),
              "ssd_scan_bwd": (ssd.ssd_scan, "bwd_launches", 0)}
    try:
        log(f"== 21. attention training main path: TrainCampaign on "
            f"KsaCluster, {ATTN_ARCH} at full width cut to "
            f"{ATTN_TRAIN['layers']} layers, {ATTN_TRAIN['total_steps']} "
            f"steps; then the full-depth step apart")
        attn_trained = phase_training(
            ATTN_TRAIN, {**_fa_counted(fa, ATTN_TRAIN["layers"]), **no_ssd},
            trainer, train_step_mod, checkpoint, data, configs, KsaCluster,
            ResourceProfile, record, workdir / "attn",
            plain_watch=plain_calls_on_card(plain_targets))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    _free()
    attn_cfg = configs.get_config(ATTN_ARCH)
    attn_step = phase_train_steps(
        f"{attn_cfg.name} at full width and depth, the campaign's step",
        attn_cfg, ATTN_TRAIN, {**_fa_counted(fa, attn_cfg.n_layers),
                               **no_ssd},
        train_step_mod, trainer, data, plain_calls_on_card(plain_targets),
        smi)
    log("== 22. one gemma3-1b train step on the card and on the CPU, float32")
    phase_attn_exactness(fa, train_step_mod, configs, optim, tree)
    _free()
    t_family = time.perf_counter()
    plain_serving = ([(fa, n) for n in FA_PLAIN]
                     + [(fd, "flash_decode_ref"),
                        (fd, "flash_decode_paged_ref"),
                        (attention_mod, "chunked_attention")])
    log(f"== 23. recurrentgemma-2b serving: KsaCluster.run_campaign("
        f"serve_pipeline) at full width, bf16, dense flash decode ({smi})")
    rg_served = phase_family_serving(
        fd, models, configs, serve, KsaCluster, ResourceProfile, RG_ARCH,
        dict(max_len=4096),
        configs.get_config(RG_ARCH).layer_kinds().count("local"), 0,
        plain_calls_on_card(plain_serving), smi)
    log(f"== 24. recurrentgemma-2b exactness at full width in float32 ({smi})")
    rg_exact = phase_rg_exactness(fa, models, configs, serve, smi)
    log(f"== 25. moonshot-v1-16b-a3b serving: KsaCluster.run_campaign("
        f"serve_pipeline) at full width cut to {MOE_SERVE_LAYERS} layers, "
        f"bf16, paged flash decode; then exactness at full width cut to "
        f"{MOE_EXACT_LAYERS} "
        f"layers, float32 ({smi})")
    moe_served = phase_family_serving(
        fd, models, configs, serve, KsaCluster, ResourceProfile, MOE_ARCH,
        dict(paged=True, page_size=64, max_len=1024), 0, MOE_SERVE_LAYERS,
        plain_calls_on_card(plain_serving), smi, layers=MOE_SERVE_LAYERS)
    moe_exact = phase_moe_exactness(models, configs, serve, smi)
    log(f"== 26. deepseek-v3-671b at full width cut to 1 layer (MLA and the "
        f"256-expert MoE; its attention is the reference's own "
        f"single-device chunked_attention, so no plain-version watch) "
        f"({smi})")
    mla = phase_mla(models, configs, serve, smi)
    t_fed = time.perf_counter()
    log(f"== 27. the federated knot campaign: FederatedCluster(edge, hpc)."
        f"run_campaign, {CAMPAIGN} structures, localize on hpc's GPU "
        f"worker ({smi})")
    fed = phase_federation(knots, writhe, knots6, smi)
    _free()
    log(f"== 28. {HUBERT_ARCH} at full width and depth: the encoder's "
        f"make_prefill_step on {ENC_BATCH} x {ENC_SEQ} frames, then "
        f"{TRAIN_STEPS} train steps ({smi})")
    hubert = phase_encoder(fa, models, configs, train_step_mod,
                           plain_calls_on_card(plain_targets), smi)
    hubert |= phase_family_train(fa, configs, train_step_mod, trainer, data,
                                 optim, tree, HUBERT_ARCH,
                                 plain_calls_on_card(plain_targets), smi)
    log(f"== 29. {VLM_ARCH} serving: KsaCluster.run_campaign("
        f"serve_pipeline) at full width and depth, bf16, dense flash decode "
        f"at G = 7; exactness at {VLM_EXACT_LAYERS} layers in float32; "
        f"{TRAIN_STEPS} train steps ({smi})")
    vlm_served = phase_family_serving(
        fd, models, configs, serve, KsaCluster, ResourceProfile, VLM_ARCH,
        dict(max_len=1024), configs.get_config(VLM_ARCH).n_layers, 0,
        plain_calls_on_card(plain_serving), smi)
    vlm_exact = phase_vlm_exactness(models, configs, serve, smi)
    vlm_trained = phase_family_train(fa, configs, train_step_mod, trainer,
                                     data, optim, tree, VLM_ARCH,
                                     plain_calls_on_card(plain_targets), smi)
    t_remat = time.perf_counter()
    log(f"== 30. remat: the {ATTN_ARCH} and {TRAIN_ARCH} steps of phases 21 "
        f"and 15 under remat='full'; then each policy against none in "
        f"float32 ({smi})")
    remat = phase_remat(fa, ssd, configs, train_step_mod, trainer, data,
                        optim, tree, plain_targets, attn_step,
                        trained["traced"], smi)
    log(f"== 31. the sharded train step on a world of one (NCCL, (data=1, "
        f"model=1) mesh): float32 parity with the unsharded step, then bf16 "
        f"steps beside it ({smi})")
    sharded = phase_sharded(fa, ssd, configs, train_step_mod, trainer, data,
                            optim, tree, plain_targets, smi)
    t_end = time.perf_counter()
    faulthandler.cancel_dump_traceback_later()
    log(f"command time: phases 1-6 {t_serve - t_start:.1f} s, phases 7-11 "
        f"{t_train - t_serve:.1f} s, phases 12-17 {t_attn - t_train:.1f} s, "
        f"phases 18-22 {t_family - t_attn:.1f} s, phases 23-26 "
        f"{t_fed - t_family:.1f} s, phases 27-29 {t_remat - t_fed:.1f} s, "
        f"phases 30-31 {t_end - t_remat:.1f} s, all {t_end - t_start:.1f} s")

    kernels = [{
        "name": "writhe_map",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/writhe.cu",
        "replaces": "src/repro/kernels/writhe.py:97",
        "launches": knots6["launches"] + fed["launches"],
        "launches_by_path": {"knots": knots6["launches"],
                             "federation": fed["launches"]},
        "max_abs_err": max(check_err, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,   # no single PyTorch call computes a writhe map
        "shape": [B_FULL, N_POINTS, 3],
        "plain_chunk": timing["plain_chunk"],
        "plain_chunk_ms": timing["plain_chunk_ms"],
        # writhe_and_acn: the map and both sums in one launch; the
        # composition: the map kernel, then the sums in PyTorch
        "fused_ms": timing["fused_ms"],
        "composition_ms": timing["composition_ms"],
        "fused_peak_bytes": peaks["writhe_and_acn"],
        "composition_peak_bytes": peaks["composition"],
        "check": "pass",
    }]
    for name, main_shape, replaces in (
            ("flash_decode", "gemma3_1b_ring",
             "src/repro/kernels/flash_decode.py:163"),
            ("flash_decode_paged", "gemma3_1b_paged",
             "src/repro/kernels/flash_decode.py:354")):
        at = fd_time[main_shape]
        kind = "paged" if "paged" in name else "dense"
        large = fd_time["large_" + kind]
        # each serving path's run, its counts set to 0 just before it
        by_path = {SERVE_ARCH: served["launches"][name],
                   RG_ARCH: rg_served["launches"][name],
                   MOE_ARCH: moe_served["launches"][name],
                   VLM_ARCH: vlm_served["launches"][name]}
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": fd_err[name],
            "ms": at["ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"],
            # scaled_dot_product_attention on the same valid keys (paged:
            # on the gathered logical view, the gather not timed)
            "library_ms": at["library_ms"],
            "shape": at["shape"] | {"case": main_shape},
            "n_split": at["n_split"],
            "blocks": at["blocks"],
            "host_us": at["host_us"],
            "max_abs_err_f32": fd_err[name + "_f32"],
            "large": large,
            "stablelm": fd_time["stablelm_" + kind],
            # G = 10: recurrentgemma-2b's ring and paged shapes
            "recurrentgemma": fd_time["recurrentgemma_2b_" + (
                "paged" if kind == "paged" else "ring")],
            # G = 7, D = 64: internvl2-1b's dense and paged shapes
            "internvl2": fd_time["internvl2_1b_" + kind],
            "check": "pass",
        })
    # each SSD path's run, its counts set to 0 just before it
    ssd_paths = {f"{TRAIN_ARCH}_campaign": trained["launches"],
                 f"{TRAIN_ARCH}_remat_step": remat[TRAIN_ARCH]["launches"],
                 f"{TRAIN_ARCH}_sharded_f32":
                     sharded[TRAIN_ARCH]["launches"],
                 f"{TRAIN_ARCH}_sharded_bf16":
                     sharded["timed"]["sharded"]["launches"]}
    ssd_by_path = {k: v["ssd_scan"] for k, v in ssd_paths.items()}
    ssd_bwd_by_path = {k: v["ssd_scan_bwd"] for k, v in ssd_paths.items()}
    kernels.append({
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:74",
        "launches": sum(ssd_by_path.values()),
        "launches_by_path": ssd_by_path,
        "max_abs_err": ssd_err["max_abs_err"],
        "ms": ssd_time["ms"],
        "plain_ms": ssd_time["plain_ms"],
        "bound_ms": ssd_time["bound_ms"],
        "bound_by": ssd_time["bound_by"],
        "library_ms": None,   # no single PyTorch call computes the SSD scan
        "shape": dict(sc.MAIN_SHAPE, dtype="bfloat16"),
        "launches_per_step": (trained["launches"]["ssd_scan"]
                              // TRAIN["total_steps"]),
        "launches_per_remat_step": (remat[TRAIN_ARCH]["launches"]
                                    ["ssd_scan"] // TRAIN_STEPS),
        "by_kernel": ssd_time["by_kernel"],
        "train_step_ms": trained["step_ms"],
        "recovery_bitwise": recovered["bitwise"],
        "check": "pass",
    })
    ssd_bwd = ssd_time["bwd"]
    kernels.append({
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:74 (its gradient: the JAX "
                    "package differentiates ssd_chunked and has no Pallas "
                    "backward)",
        "launches": sum(ssd_bwd_by_path.values()),
        "launches_by_path": ssd_bwd_by_path,
        "max_abs_err": ssd_bwd_err["max_abs_err"],
        "ms": ssd_bwd["ms"],
        "plain_ms": ssd_bwd["plain_ms"],
        "bound_ms": ssd_bwd["bound_ms"],
        "bound_by": ssd_bwd["bound_by"],
        "library_ms": None,   # no single PyTorch call computes the gradient
        "shape": dict(sc.MAIN_SHAPE, dtype="bfloat16"),
        "main_rel_err": ssd_bwd_err["main_rel"],
        "by_kernel": ssd_bwd["by_kernel"],
        "launches_per_step": (trained["launches"]["ssd_scan_bwd"]
                              // TRAIN["total_steps"]),
        "check": "pass",
    })
    main_fa = fa_time["gemma3_1b_global"]
    # each training and encoder path's run, its counts set to 0 just
    # before it
    fa_paths = {f"{ATTN_ARCH}_campaign": attn_trained["launches"],
                f"{ATTN_ARCH}_step": attn_step["launches"],
                f"{HUBERT_ARCH}_step": hubert["launches"],
                f"{VLM_ARCH}_step": vlm_trained["launches"],
                f"{ATTN_ARCH}_remat_step": remat[ATTN_ARCH]["launches"],
                f"{MOE_ARCH}_sharded_f32": sharded[MOE_ARCH]["launches"]}
    fa_by_path = {k: v["flash_attention"] for k, v in fa_paths.items()}
    fa_by_path[f"{HUBERT_ARCH}_prefill"] = hubert["prefill_launches"]
    bwd_by_path = {k: v["flash_attention_bwd"] for k, v in fa_paths.items()}
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:119",
        "launches": sum(fa_by_path.values()),
        "launches_by_path": fa_by_path,
        "max_abs_err": fa_err["max_abs_err"],
        "ms": main_fa["ms"],
        "plain_ms": main_fa["plain_ms"],
        "bound_ms": main_fa["bound_ms"],
        "bound_by": main_fa["bound_by"],
        # scaled_dot_product_attention, is_causal and enable_gqa
        "library_ms": main_fa["library_ms"],
        "library_backend": main_fa["library_backend"],
        "fma_design_ms": main_fa["fma_ms"],
        "shape": dict(main_fa["shape"], dtype="bfloat16",
                      case="gemma3_1b_global"),
        "local": {k: v for k, v in fa_time["gemma3_1b_local"].items()
                  if k != "bwd"},
        "stablelm": {k: v for k, v in fa_time["stablelm_1_6b"].items()
                     if k != "bwd"},
        "max_abs_err_f32": fa_err["f32_err"],
        "launches_per_step": (attn_step["launches"]["flash_attention"]
                              // TRAIN_STEPS),
        "launches_per_remat_step": (remat[ATTN_ARCH]["launches"]
                                    ["flash_attention"] // TRAIN_STEPS),
        "train_step_ms": attn_step["step_ms"],
        "check": "pass",
    })
    main_bwd = main_fa["bwd"]
    kernels.append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:119 (its "
                    "gradient: the JAX package differentiates "
                    "chunked_attention and has no Pallas backward)",
        "launches": sum(bwd_by_path.values()),
        "launches_by_path": bwd_by_path,
        "max_abs_err": fa_err["bwd_main_err"]["gemma3_1b_global"],
        "ms": main_bwd["ms"],
        "plain_ms": main_bwd["plain_ms"],
        "bound_ms": main_bwd["bound_ms"],
        "bound_by": main_bwd["bound_by"],
        # scaled_dot_product_attention's backward, through autograd
        "library_ms": main_bwd["library_ms"],
        "library_backend": main_bwd["library_backend"],
        "shape": dict(main_fa["shape"], dtype="bfloat16",
                      case="gemma3_1b_global"),
        "local": fa_time["gemma3_1b_local"]["bwd"],
        "stablelm": fa_time["stablelm_1_6b"]["bwd"],
        "max_abs_err_f32": fa_err["bwd_f32_err"],
        "launches_per_step": (attn_step["launches"]["flash_attention_bwd"]
                              // TRAIN_STEPS),
        "check": "pass",
    })
    families = {RG_ARCH: {**{k: rg_served[k] for k in (
                    "makespan_s", "tokens_per_s", "steps", "step_ms",
                    "peak_bytes", "bound_ms")}, **rg_exact},
                MOE_ARCH: {**{k: moe_served[k] for k in (
                    "makespan_s", "tokens_per_s", "steps", "step_ms",
                    "peak_bytes", "bound_ms")}, **moe_exact},
                MLA_ARCH: mla,
                "federation": fed,
                HUBERT_ARCH: {k: v for k, v in hubert.items()
                              if k != "launches"},
                VLM_ARCH: {**{k: vlm_served[k] for k in (
                    "makespan_s", "tokens_per_s", "steps", "step_ms",
                    "peak_bytes", "bound_ms")}, **vlm_exact,
                    "train": {k: v for k, v in vlm_trained.items()
                              if k != "launches"}},
                f"{ATTN_ARCH}_campaign": {
                    k: attn_trained[k] for k in (
                        "makespan_s", "step_ms", "saves", "restores",
                        "peak_bytes")} | {"layers": ATTN_TRAIN["layers"]},
                f"{ATTN_ARCH}_step": {k: v for k, v in attn_step.items()
                                      if k != "launches"},
                "remat": {TRAIN_ARCH: {k: v for k, v in
                                       remat[TRAIN_ARCH].items()
                                       if k != "launches"},
                          ATTN_ARCH: {k: v for k, v in
                                      remat[ATTN_ARCH].items()
                                      if k != "launches"},
                          "exact": remat["exact"]},
                "sharded": sharded}
    print(json.dumps({"families": families}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
