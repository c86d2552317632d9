"""Dry-run of every (architecture x shape) cell on the production meshes:
what each device holds and computes, with no world and no device.

Port of ``repro/launch/dryrun.py``, its purpose only. The reference lowers
and compiles each cell with XLA on 512 placeholder host devices and reads
the compiler's memory analysis, its cost analysis and the collectives in
the partitioned HLO. None of that exists for an eager PyTorch program, so
this module computes what carries over from the port's own specs:

* ``model_flops``, exactly as the reference's (6 N D to train, 2 N D to
  prefill, 2 N B to decode one token; N the active parameters);
* the per-device bytes of every cell's arguments and outputs, from the
  local shard shapes that :mod:`repro_torch.launch.specs` gives each leaf
  on the mesh (exact: the rules shard a dim only where the mesh divides
  it). Caches are written in place (aliased); a train step's state is not
  (the port's step returns a new one beside the old). Temporaries have no
  counterpart without a compiler's buffer assignment: ``temp_bytes`` is
  null;
* operations by ``torch.utils.flop_counter.FlopCounterMode``, counted on
  ``meta`` tensors (no storage; the kernels' wrappers take their plain
  versions there and launch nothing) through the cell's costing variant
  at two reduced depths, extrapolated linearly to full depth as the
  reference does (the stack's periods are identical); a train cell counts
  one microbatch's forward and backward, times the microbatches, plus the
  optimizer analytically. The costing variant is the unsharded program
  at the cell's global shapes (:func:`repro_torch.launch.specs.make_cell`),
  so the per-device count is its count over the devices: what a program
  that splits every operation evenly does. It leaves out what the sharded
  program repeats (the SSD, RG-LRU and MLA mixers run on every ``model``
  rank) and counts matrix products only, as ``FlopCounterMode`` does;
* a roofline with the H100's constants (NVIDIA's data sheet, SXM part,
  dense, at its 700 W limit): compute time, the time to stream every
  resident byte once, and the larger as the bound. No collective time
  (no partitioned program to read it from) and no bytes-accessed count.

Usage (any host; no GPU, no world)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--single-pod | --multi-pod | --both]
        [--out results/dryrun_torch] [--force]

Each cell writes one JSON file (a rerun skips what exists unless
``--force``) with the reference's keys where they carry over.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, cells_for, get_config
from repro_torch.launch.mesh import mesh_axes
from repro_torch.launch.specs import (make_cell, optimizer_analytic_costs,
                                      optimizer_for, resolve_knobs)
from repro_torch.models.layers import torch_dtype
from repro_torch.sharding import DistContext
from repro_torch.sharding.rules import axis_size, entry_axes
from repro_torch.tree import leaves

# NVIDIA H100 (SXM) data sheet, dense rates, at the card's full 700 W
DEVICE = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"
PEAK_FLOPS = 989e12       # bf16 FLOP/s per card
HBM_BW = 3.35e12          # bytes/s per card
HBM_BYTES = 80e9


def model_flops(cfg, shape) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE); decode D = new tokens only."""
    n = cfg.param_count(active_only=True)
    if shape.step == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.step == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of the local shard of ``t`` (a tensor or ``meta`` tensor)
    placed by ``spec`` (None: whole on every rank) on ``mesh``."""
    shape = list(t.shape)
    for i, entry in enumerate(spec or ()):
        shape[i] //= axis_size(mesh, entry_axes(entry))
    n = 1
    for s in shape:
        n *= s
    return n * t.element_size()


def tree_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of every tensor leaf of ``tree`` placed by the
    matching spec of ``specs`` (``None``: every leaf whole)."""
    from repro_torch.sharding.context import _spec_leaves
    ts = [t for t in leaves(tree) if isinstance(t, torch.Tensor)]
    ss = [None] * len(ts) if specs is None else _spec_leaves(specs)
    assert len(ts) == len(ss), (len(ts), len(ss))
    return sum(shard_bytes(t, s, mesh) for t, s in zip(ts, ss))


def _outputs(cell, cfg, shape) -> tuple[list, list, int]:
    """(output trees, their specs, the argument bytes the outputs alias):
    a train step's new state; the last position's logits, the greedy ids
    and the caches of a decode or prefill step (the caches written in
    place); an encoder's logits."""
    b = shape.global_batch
    logits = lambda *s: torch.empty(s, dtype=torch_dtype(cfg.logit_dtype),
                                    device="meta")
    notes = cell.static_notes["step"]
    if notes == "train":
        return [cell.args[0]], [cell.out_shardings[0]], 0
    if cfg.encoder_only:
        return [logits(b, shape.seq_len, cfg.padded_vocab)], [None], 0
    caches = cell.args[2]
    outs = [logits(b, cfg.padded_vocab), caches]
    specs = [None, cell.in_shardings[2]]
    if notes == "decode":
        outs.append(torch.empty((b,), dtype=torch.int32, device="meta"))
        specs.append(None)
    return outs, specs, 1


def count_flops(cell) -> float:
    """Matrix-product FLOPs of one call of the cell's step on its
    arguments (``meta`` tensors: nothing is computed or allocated)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        cell.fn(*cell.args)
    return float(counter.get_total_flops())


def costing_depths(n_periods: int) -> tuple[int, int]:
    """The two reduced depths the counts extrapolate from (the
    reference's)."""
    return (2, 4) if n_periods >= 4 else (1, max(2, n_periods))


def costed_flops(arch: str, shape, dist) -> dict:
    """Per-device FLOPs of a cell's step: counted at the two costing
    depths, extrapolated to full depth, times the microbatches (train),
    over the devices, plus the optimizer's analytic cost."""
    cfg = get_config(arch)
    n_p = cfg.n_periods
    l1, l2 = costing_depths(n_p)
    k1 = count_flops(make_cell(arch, shape, dist, costing_periods=l1))
    if l2 != l1 and n_p != l1:
        k2 = count_flops(make_cell(arch, shape, dist, costing_periods=l2))
    else:
        k2, l2 = k1, l1
    total = k2 if l2 == l1 else k2 + (k2 - k1) / (l2 - l1) * (n_p - l2)
    mb = 1
    n_dev = dist.n_devices
    per_device = total / n_dev
    if shape.step == "train":
        knobs = resolve_knobs(cfg, dist, shape.global_batch)
        mb = max(1, knobs.get("microbatch") or 1)
        per_device *= mb
        per_device += optimizer_analytic_costs(
            cfg, optimizer_for(cfg), knobs.get("accum_dtype", "float32"),
            n_dev)["flops_per_device"]
    return {"flops_per_device": per_device, "flops_total": total * mb,
            "costing_periods": [l1, l2], "costing_flops": [k1, k2],
            "microbatch": mb}


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False) -> dict:
    """One cell's record: memory per device from the specs, FLOPs by the
    costing counts (single-pod cells only, as the reference's roofline
    table), the roofline; written to ``out_dir``."""
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}__{shape_name}__{mesh_tag}"
    out_path = out_dir / f"{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                 "step": shape.step, "seq_len": shape.seq_len,
                 "global_batch": shape.global_batch}
    t0 = time.time()
    try:
        axes = mesh_axes(multi_pod=multi_pod)
        dist = DistContext(axes)
        cell = make_cell(arch, shape, dist)
        arg_b = sum(tree_bytes(a, s, axes)
                    for a, s in zip(cell.args, cell.in_shardings))
        outs, out_specs, aliased = _outputs(cell, cfg, shape)
        out_b = sum(tree_bytes(o, s, axes) for o, s in zip(outs, out_specs))
        alias_b = tree_bytes(cell.args[2], cell.in_shardings[2], axes) \
            if aliased else 0
        total = arg_b + out_b - alias_b
        rec["memory"] = {
            "argument_bytes": arg_b, "output_bytes": out_b,
            # no compiler's buffer assignment: temporaries are not known
            "temp_bytes": None, "alias_bytes": alias_b,
            "per_device_total_bytes": total,
            "fits_80gb": bool(total < HBM_BYTES)}
        rec["timings"] = {"specs_s": time.time() - t0}
        rec["ok"] = True
        if not multi_pod:
            t1 = time.time()
            cost = costed_flops(arch, shape, dist)
            rec["cost"] = cost
            rec["timings"]["costing_s"] = time.time() - t1
            flops = cost["flops_per_device"]
            mf = model_flops(cfg, shape)
            n_dev = dist.n_devices
            comp_t = flops / PEAK_FLOPS
            floor_t = total / HBM_BW
            bound = max(comp_t, floor_t)
            rec["roofline"] = {
                "device": DEVICE, "power_limit": POWER_LIMIT,
                "peak_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                "compute_s": comp_t,
                "memory_s": None,          # no bytes-accessed count
                "memory_floor_s": floor_t,
                "collective_s": None,      # no partitioned program to read
                "dominant": "compute" if comp_t >= floor_t else "memory",
                "model_flops_total": mf,
                "model_flops_per_device": mf / n_dev,
                "useful_flops_ratio": (mf / n_dev) / flops if flops else 0.0,
                "step_time_bound_s": bound,
                "mfu_bound": (mf / n_dev / PEAK_FLOPS) / bound
                             if bound > 0 else 0.0,
            }
    except Exception as exc:  # noqa: BLE001 — record the failure, keep going
        rec["ok"] = False
        rec["error"] = repr(exc)
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["elapsed_s"] = time.time() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    r = rec.get("roofline", {})
    mem = rec.get("memory", {})
    print(f"[{'OK ' if rec.get('ok') else 'FAIL'}] {name}  "
          f"per-device {mem.get('per_device_total_bytes', 0) / 1e9:.2f} GB "
          f"compute={r.get('compute_s', 0):.4f}s "
          f"floor={r.get('memory_floor_s', 0):.4f}s "
          f"dom={r.get('dominant', '-')} mfu_bound={r.get('mfu_bound', 0):.3f}"
          f" ({rec['elapsed_s']:.1f}s)", flush=True)
    if not rec.get("ok"):
        print(rec.get("error"), flush=True)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    meshes = []
    if args.both or (not args.multi_pod and not args.single_pod):
        meshes = [False, True]
    else:
        if args.single_pod:
            meshes.append(False)
        if args.multi_pod:
            meshes.append(True)
    archs = [args.arch] if args.arch else list(ARCHS)
    out_dir = Path(args.out)
    results = []
    for arch in archs:
        shapes = cells_for(arch)
        if args.shape:
            shapes = [s for s in shapes if s.name == args.shape]
        for shape in shapes:
            for mp in meshes:
                results.append(run_cell(arch, shape.name, mp, out_dir,
                                        force=args.force))
    ok = sum(r.get("ok", False) for r in results)
    print(f"\n{ok}/{len(results)} cells costed successfully")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
