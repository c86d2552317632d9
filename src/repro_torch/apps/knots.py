"""Knot detection over predicted protein structures — the paper's workload
(§4), ported to PyTorch with the writhe map as a CUDA kernel.

Counterpart of ``repro/apps/knots.py``: the same AlphaKnot 2.0 pipeline
(quality filter, writhe/ACN screen, knot-core localization), the same task
names and the same campaign DAG. The structure synthesis, the quality score
and the knot-core scan are numpy and are verbatim copies of the reference's
(``tests/test_torch_knots.py`` holds them to it); the writhe map is
:func:`repro_torch.kernels.ops.writhe`, the hand-written kernel for a CUDA
tensor and the plain PyTorch version for a CPU tensor.

Every task reads ``params["device"]`` (default ``"cuda"``) and raises when
CUDA is asked for and missing; pass ``device="cpu"`` to run on the CPU.
The port's :func:`register_script` has a registry of its own, so the tasks
keep the reference's names.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.core import ClusterComputing, register_script
from repro_torch.kernels import ops as kops
from repro_torch.kernels.writhe import writhe_map_sums

WRITHE_KNOT_THRESHOLD = 2.5   # |Wr| above this ⇒ knot candidate
QUALITY_THRESHOLD = 0.70      # emulated pLDDT cut (paper: 70)
HOST_BLOCK = 128              # writhe maps copied to the host at a time


# ---------------------------------------------------------------------------
# synthetic structure generation (numpy, verbatim from the reference)
# ---------------------------------------------------------------------------

def torus_knot(p: int, q: int, n: int, scale: float = 1.0,
               noise: float = 0.0, seed: int = 0) -> np.ndarray:
    """(p, q) torus-knot backbone with n residues (3_1 = (2,3), 5_1 = (2,5))."""
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    r = np.cos(q * t) + 2.0
    pts = np.stack([r * np.cos(p * t), r * np.sin(p * t),
                    -np.sin(q * t)], -1) * scale
    if noise:
        pts = pts + np.random.RandomState(seed).randn(n, 3) * noise
    return pts.astype(np.float32)


def figure8(n: int, noise: float = 0.0, seed: int = 0) -> np.ndarray:
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([
        (2 + np.cos(2 * t)) * np.cos(3 * t),
        (2 + np.cos(2 * t)) * np.sin(3 * t),
        np.sin(4 * t)], -1)
    if noise:
        pts = pts + np.random.RandomState(seed).randn(n, 3) * noise
    return pts.astype(np.float32)


def random_coil(n: int, seed: int = 0,
                drift: tuple[float, float, float] = (1.0, 0.0, 0.0)
                ) -> np.ndarray:
    """Extended random coil: a drift term keeps the open chain from
    collapsing into a geometrically-entangled globule (unbiased walks often
    carry |Wr| > 3 — real, but noise for a screening benchmark)."""
    rng = np.random.RandomState(seed)
    steps = rng.randn(n, 3)
    steps /= np.linalg.norm(steps, axis=1, keepdims=True)
    steps = steps + np.asarray(drift)
    return np.cumsum(steps * 1.2, axis=0).astype(np.float32)


def deep_knot(n: int, core: int = 80, seed: int = 0) -> np.ndarray:
    """A trefoil core embedded mid-chain between two *extended* tails — the
    paper's 'deep knot' (Taylor 2000): trimming the tails keeps the knot.

    The torus-knot cut leaves both endpoints adjacent in space, so both tails
    must exit on the same side (radially outward) — ends that wander back
    through the loop would untie the open chain, which is exactly the
    shallow-knot failure mode the deep/shallow distinction is about."""
    tre = torus_knot(2, 3, core, scale=1.2, noise=0.03, seed=seed)
    center = tre.mean(0)
    d = tre[0] - center
    d = d / (np.linalg.norm(d) + 1e-9) * 5.0
    tail = (n - core) // 2
    head = random_coil(tail, seed + 1, drift=tuple(d)) + tre[0]
    foot = random_coil(n - core - tail, seed + 2, drift=tuple(d)) + tre[-1]
    return np.concatenate([head[::-1], tre, foot], 0).astype(np.float32)


def synthesize_batch(ids: list[int], n_points: int = 128) -> tuple[np.ndarray, list[str]]:
    """Deterministic mixed population keyed by structure id.

    Note: the figure-8 knot is amphichiral (Wr ≈ 0) and *invisible* to a
    writhe screen — exactly why the paper's pipeline computes HOMFLY-PT.
    The population here uses chiral knots (3_1, 5_1); the figure-8
    limitation is asserted explicitly in tests/test_knots.py."""
    out, truth = [], []
    for i in ids:
        kind = i % 4
        if kind == 0:
            out.append(torus_knot(2, 3, n_points, noise=0.05, seed=i))
            truth.append("trefoil")
        elif kind == 1:
            out.append(random_coil(n_points, seed=i))
            truth.append("unknot")
        elif kind == 2:
            out.append(torus_knot(2, 5, n_points, noise=0.05, seed=i))
            truth.append("cinquefoil")
        else:
            out.append(deep_knot(n_points, core=max(n_points // 2, 48),
                                 seed=i))
            truth.append("deep_trefoil")
    return np.stack(out), truth


def quality_score(ids: list[int]) -> np.ndarray:
    """Emulated pLDDT in [0.4, 1.0] (deterministic per id). ~15% of
    structures fall below the cut, mirroring the paper's 54M/214M drop."""
    rng = np.random.RandomState(12345)
    all_q = 0.4 + 0.6 * rng.random(10_000_000)
    return np.array([all_q[i % len(all_q)] for i in ids], np.float32)


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def writhe_and_acn(coords: torch.Tensor, *, use_pallas: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """coords (B, n, 3) -> (total writhe (B,), ACN (B,), writhe map
    (B, n-1, n-1)), on the device of ``coords``. On the card one kernel
    launch writes the map and both sums (no second map-sized tensor); on
    the CPU the plain map, then ``W.sum() / 2`` and ``|W|.sum() / 2``.
    ``use_pallas`` is kept for signature parity."""
    del use_pallas
    return writhe_map_sums(coords)


def knot_core(wmap: np.ndarray, threshold: float = WRITHE_KNOT_THRESHOLD,
              min_len: int = 16, check_cancel=None) -> tuple[int, int] | None:
    """Knot-core localization (paper §4: the subchain heuristic replacing
    the O(n²)-subchain Alexander knot map at AlphaFold scale).

    Shrinks [a, b) greedily from both ends while |writhe(subchain)| stays
    above threshold; O(n) evaluations over the precomputed map's prefix
    sums instead of O(n²) invariant computations. ``check_cancel`` is
    called once per shrink step — the O(chain-length) loop here is where a
    long localization actually spends its time, so a revoked lease must be
    observed *inside* it, not only between structures."""
    n = wmap.shape[0]
    # 2D prefix sums for O(1) subchain writhe
    ps = np.zeros((n + 1, n + 1))
    ps[1:, 1:] = np.cumsum(np.cumsum(wmap, 0), 1)

    def sub_writhe(a: int, b: int) -> float:
        return (ps[b, b] - ps[a, b] - ps[b, a] + ps[a, a]) / 2.0

    a, b = 0, n
    if abs(sub_writhe(a, b)) < threshold:
        return None
    changed = True
    while changed and b - a > min_len:
        if check_cancel is not None:
            check_cancel()
        changed = False
        if abs(sub_writhe(a + 1, b)) >= threshold:
            a += 1
            changed = True
        if b - a > min_len and abs(sub_writhe(a, b - 1)) >= threshold:
            b -= 1
            changed = True
    return (a, b)


def classify(wr: float) -> str:
    if abs(wr) < WRITHE_KNOT_THRESHOLD:
        return "unknot"
    return "knotted"


# ---------------------------------------------------------------------------
# the KSA task (paper Fig. 3 pattern)
# ---------------------------------------------------------------------------

def _screen_batch(ids: list[int], n_points: int, use_pallas: bool,
                  device: str = "cuda"
                  ) -> tuple[list[int], list[int], dict[str, float], float]:
    """Quality-filter + writhe/ACN screen one batch of structure ids.
    -> (kept_ids, knotted_ids, writhe per knotted id, mean ACN over kept)."""
    dev = resolve_device(device)
    q = quality_score(ids)
    keep = q >= QUALITY_THRESHOLD
    kept_ids = [i for i, k in zip(ids, keep) if k]
    if not kept_ids:
        return [], [], {}, 0.0
    coords, _ = synthesize_batch(kept_ids, n_points)
    wr, acn, _ = writhe_and_acn(torch.from_numpy(coords).to(dev),
                                use_pallas=use_pallas)
    wr = wr.cpu().numpy()
    knotted = [int(i) for i, w in zip(kept_ids, wr)
               if abs(float(w)) >= WRITHE_KNOT_THRESHOLD]
    knotted_set = set(knotted)
    wr_by_id = {str(i): float(w) for i, w in zip(kept_ids, wr)
                if int(i) in knotted_set}
    return kept_ids, knotted, wr_by_id, float(acn.cpu().numpy().mean())


def _localize_cores(survivors: list[int], n_points: int, use_pallas: bool,
                    check_cancel, device: str = "cuda") -> dict[str, list[int]]:
    """Knot-core localization for screen survivors. Shared by the flat
    ``knot_batch`` task and the pipeline ``knot_localize`` stage so the two
    paths cannot drift apart.

    ``check_cancel`` is called in every O(chain-length) loop (per structure
    here, and inside each :func:`knot_core` shrink loop), so a revoked lease
    stops the task promptly instead of after the whole batch."""
    dev = resolve_device(device)
    cores: dict[str, list[int]] = {}
    if not survivors:
        return cores
    coords, _ = synthesize_batch(survivors, n_points)
    wmap = kops.writhe(torch.from_numpy(coords).to(dev),
                       use_pallas=use_pallas)
    # the map comes to the host a block at a time: at the paper's batch size
    # (4000 x 512 points) the whole map is 4 GB, and a task's RSS growth is
    # policed against its Resources.mem_mb (1 GB by default)
    for start in range(0, len(survivors), HOST_BLOCK):
        block = wmap[start:start + HOST_BLOCK].cpu().numpy()
        for k, i in enumerate(survivors[start:start + HOST_BLOCK]):
            check_cancel()
            core = knot_core(block[k], check_cancel=check_cancel)
            if core is not None:
                cores[str(i)] = list(core)
    return cores


def _device(params: dict) -> str:
    return str(params.get("device", "cuda"))


@register_script("knot_batch")
class KnotBatchComputing(ClusterComputing):
    """params: batch (list of structure ids), n_points, stage2 (bool),
    device. One task = one batch of structures (paper:
    4000/batch). Flat single-stage baseline: screen + localize fused in one
    task, built on the same helpers the pipeline stages use."""

    def run(self) -> Any:
        ids = list(self.params["batch"])
        n_points = int(self.params.get("n_points", 128))
        stage2 = bool(self.params.get("stage2", True))
        device = _device(self.params)

        kept_ids, knotted, _, mean_acn = _screen_batch(ids, n_points, False,
                                                       device)
        self.send_status("RUNNING", stage="screen", kept=len(kept_ids),
                         dropped=len(ids) - len(kept_ids))
        self.check_cancel()

        cores: dict[str, list[int]] = {}
        if stage2 and knotted:
            self.send_status("RUNNING", stage="knot_core",
                             candidates=len(knotted))
            cores = _localize_cores(knotted, n_points, False,
                                    self.check_cancel, device)
        return {
            "processed": len(ids),
            "kept": len(kept_ids),
            "knotted": knotted,
            "cores": cores,
            "mean_acn": mean_acn,
        }


# ---------------------------------------------------------------------------
# the campaign as a 3-stage DAG (repro_torch.pipeline)
# ---------------------------------------------------------------------------

@register_script("knot_screen")
class KnotScreenComputing(ClusterComputing):
    """Stage 1 (source, fan-out): generate + quality-filter + writhe/ACN
    screen one batch. params: batch (ids), n_points, device."""

    def run(self) -> Any:
        ids = list(self.params["batch"])
        n_points = int(self.params.get("n_points", 128))
        kept_ids, knotted, wr_by_id, mean_acn = _screen_batch(
            ids, n_points, False, _device(self.params))
        self.send_status("RUNNING", stage="screen", kept=len(kept_ids),
                         survivors=len(knotted))
        self.check_cancel()
        return {
            "processed": len(ids),
            "kept": len(kept_ids),
            "knotted": knotted,
            "wr": wr_by_id,
            "mean_acn": mean_acn,
        }


@register_script("knot_localize")
class KnotLocalizeComputing(ClusterComputing):
    """Stage 2 (map, 1:1 with screen tasks): knot-core localization on the
    survivors of one screen batch. The upstream screen result arrives as
    ``params["upstream"]``; coordinates are re-synthesized for survivors
    only."""

    def run(self) -> Any:
        upstream = dict(self.params.get("upstream") or {})
        survivors = [int(i) for i in upstream.get("knotted", [])]
        n_points = int(self.params.get("n_points", 128))
        cores = _localize_cores(survivors, n_points, False,
                                self.check_cancel, _device(self.params))
        return {"candidates": len(survivors), "cores": cores}


@register_script("knot_aggregate")
class KnotAggregateComputing(ClusterComputing):
    """Stage 3 (join barrier): aggregate every screen + localize result into
    the campaign-level report. Fires exactly once per campaign."""

    def run(self) -> Any:
        upstream = dict(self.params.get("upstream") or {})
        screens = [r for r in upstream.get("screen", []) if r]
        locs = [r for r in upstream.get("localize", []) if r]
        processed = sum(int(r.get("processed", 0)) for r in screens)
        kept = sum(int(r.get("kept", 0)) for r in screens)
        knotted = sorted({int(i) for r in screens
                          for i in r.get("knotted", [])})
        cores: dict[str, list[int]] = {}
        for r in locs:
            cores.update(r.get("cores", {}))
        acn_num = sum(float(r.get("mean_acn", 0.0)) * int(r.get("kept", 0))
                      for r in screens)
        return {
            "processed": processed,
            "kept": kept,
            "knotted": knotted,
            "cores": cores,
            "mean_acn": acn_num / kept if kept else 0.0,
            "batches": len(screens),
        }


def _no_survivors(screen_result: Any) -> bool:
    """Conditional-edge predicate: a screen batch with no knot candidates has
    nothing to localize."""
    return not screen_result.get("knotted")


def knots_pipeline(batch_size: int = 12, *, n_points: int = 96,
                   use_pallas: bool = False,
                   max_in_flight: int | None = None,
                   max_attempts: int = 4,
                   task_timeout_s: float | None = None,
                   skip_empty: bool = True,
                   gpu_localize: bool = False,
                   localize_site: str = "",
                   device: str = "cuda"):
    """The AlphaKnot campaign as a declarative 3-stage DAG:
    screen (fan-out) → localize (map over survivors) → aggregate (join).

    Same stages, resources and options as the reference's
    ``knots_pipeline``, plus ``device``, which every stage receives in its
    params: the writhe map runs there. ``gpu_localize`` routes the
    localize stage to the GPU class topic (``Resources(gpus=1)``), so only
    GPU-profiled workers lease it."""
    from repro_torch.pipeline import PipelineSpec, RetryPolicy, Stage
    from repro_torch.core import Resources

    retry = RetryPolicy(max_attempts=max_attempts, timeout_s=task_timeout_s)
    del use_pallas     # accepted for signature parity; no stage reads it
    common = {"n_points": n_points, "device": device}
    localize_res = (Resources(cpus=1, gpus=1) if gpu_localize
                    else Resources(cpus=2))
    localize_res.site = localize_site
    return PipelineSpec("alphaknot", [
        Stage("screen", "knot_screen", fan_out=batch_size, params=common,
              resources=Resources(cpus=1), max_in_flight=max_in_flight,
              retry=retry),
        Stage("localize", "knot_localize", depends_on=("screen",),
              params=common, resources=localize_res,
              max_in_flight=max_in_flight, retry=retry,
              skip_when=_no_survivors if skip_empty else None),
        Stage("aggregate", "knot_aggregate",
              depends_on=("screen", "localize"), join=True,
              params={"device": device}, retry=retry),
    ])
