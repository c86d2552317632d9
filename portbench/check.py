"""The comparisons that decide ``correct``: what the program produced beside
what the reference works out from the same inputs. Each returns named
numbers; a run is correct when each is at or under its limit, read from
``limits/<workload>.json``.

Training (the first ``check_steps`` steps of the very train state that the
window drives on):

* ``loss_gap``: the largest gap of a step's loss, relative to the
  reference's;
* ``grad_gap``: the first step's gradient as the optimizer gets it (clipped),
  by the worst leaf: the gap between the program's norm of the leaf and the
  reference's, over the larger of the reference's norm of that leaf and of
  the median leaf (one layer's slice of a layer-stacked tensor is a
  leaf);
* ``change_gap``: the same of the parameters' change over the checked steps
  (the float32 master copy that the next step starts from), leaving out the
  leaves whose reference gradient is under a thousandth of the median
  leaf's: nothing but rounding moves them under Adam;
* ``grad_mid``: the median leaf's gap of the first gradient, steady from
  seed to seed where the worst leaf is a small one that swings (a cell's
  limits say which numbers are compared).

Encoding (calls of the window drawn from the seed):

* ``clip_gap``: the largest relative Frobenius gap of a row's logits;
* ``frame_gap``: the largest gap of one position's logits, over the larger
  of the reference's norm of that position and of the median position.
"""
from __future__ import annotations

import statistics

import torch

ZERO_GRAD_SHARE = 1e-3


def leaf_norms(items) -> dict[str, float]:
    """Norms of (path, tensor) leaves. The program stores each kind of a
    layer's weights for all layers in one tensor (its path under
    ``periods``); each layer's slice of it is a leaf here, as it is of the
    model."""
    names, norms = [], []
    for path, t in items:
        name = "/".join(path)
        t = t.detach().float()
        if path[0] == "periods":
            per = t.flatten(1).norm(dim=1)
            names += [f"{name}[{i}]" for i in range(per.shape[0])]
            norms.append(per)
        else:
            names.append(name)
            norms.append(t.norm().reshape(1))
    return dict(zip(names, torch.cat(norms).double().cpu().tolist()))


def _gaps(got: dict[str, float], want: dict[str, float],
          keep: set[str] | None = None) -> dict[str, float]:
    names = [k for k in want if keep is None or k in keep]
    floor = statistics.median(want[k] for k in names)
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in names}


def _moved(ref: dict) -> set[str]:
    floor = statistics.median(ref["grad"].values())
    return {k for k, v in ref["grad"].items() if v >= ZERO_GRAD_SHARE * floor}


def train_gaps(prog: dict, ref: dict) -> dict[str, float]:
    """prog and ref: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}."""
    grad = list(_gaps(prog["grad"], ref["grad"]).values())
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in
                            zip(prog["losses"], ref["losses"])),
            "grad_gap": max(grad), "grad_mid": statistics.median(grad),
            "change_gap": max(_gaps(prog["change"], ref["change"],
                                    _moved(ref)).values())}


def train_detail(prog: dict, ref: dict) -> dict:
    """What lies behind :func:`train_gaps`, for setting its limits: each
    step's loss on both sides and its gap, the three worst leaves of each
    norm, and the leaves left out of the change."""
    def top(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    return {"losses": [[p, r, abs(p - r) / abs(r)] for p, r in
                       zip(prog["losses"], ref["losses"])],
            "grad_top": top(_gaps(prog["grad"], ref["grad"])),
            "change_top": top(_gaps(prog["change"], ref["change"],
                                    _moved(ref))),
            "left_out": sorted(set(ref["grad"]) - _moved(ref))}


def encode_gaps(got: torch.Tensor, want: torch.Tensor) -> dict[str, float]:
    """got, want: (B, S, units) logits of the same inputs."""
    got, want = got.double(), want.double()
    diff = got - want
    clip = (diff.flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max()
    frame_ref = want.norm(dim=-1)
    floor = frame_ref.flatten().median()
    frame = (diff.norm(dim=-1) / torch.clamp_min(frame_ref, floor)).max()
    return {"clip_gap": float(clip), "frame_gap": float(frame)}


def worst_of(readings: list[dict[str, float]]) -> dict[str, float]:
    """The largest reading of each number over several comparisons."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def verdict(gaps: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, dict[str, list[float]]]:
    """(every number that has a limit at or under it, {name: [number,
    limit]}). A number without a limit is read but not compared."""
    checks = {k: [gaps[k], float(limits[k])] for k in limits}
    ok = all(v <= lim for v, lim in checks.values())
    return ok, checks
