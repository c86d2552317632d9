"""The reduction of a ``torch.profiler`` trace of a stretch of steps or calls
to what the per-layer metrics and the breakdown read.

* busy seconds: the union of the device's activity intervals (kernels,
  copies, sets); the stretch's wall time is measured around it by the
  caller, between two synchronisations;
* device time under an entry point: every device operation is linked by
  the profiler's correlation to the host op that launched it; its time is
  credited to that op and to each op around it on the host (so a kernel
  launched inside ``SSDScanFn`` counts for ``SSDScanFn``, whatever the
  kernel is named or however many there are);
* the device operations that took most time, by name;
* the idle gaps between device activity, each labelled with the innermost
  host op running at the gap's middle, summed by label.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Trace:
    window_s: float
    busy_s: float = 0.0
    under: dict = field(default_factory=dict)   # op name -> [calls, s]
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def entry(self, name: str) -> tuple[int, float] | None:
        """(calls, device seconds) under the host op ``name``, or None
        where the stretch never ran it or it launched nothing."""
        got = self.under.get(name)
        if not got or got[1] <= 0:
            return None
        return got[0], got[1]


def _is_device(e) -> bool:
    return e.device_type.name in ("CUDA", "PrivateUse1")


def summarize(prof, window_s: float, top: int = 10) -> Trace:
    events = list(prof.events())
    out = Trace(window_s=window_s)
    host = [e for e in events if not _is_device(e)]
    device = [e for e in events if _is_device(e)]

    calls: dict[str, int] = defaultdict(int)
    for e in host:
        calls[e.name] += 1
    seconds: dict[str, float] = defaultdict(float)
    for e in host:
        own = sum(k.duration for k in e.kernels) * 1e-6
        if own <= 0:
            continue
        names, p = set(), e
        while p is not None:
            names.add(p.name)
            p = p.cpu_parent
        for n in names:
            seconds[n] += own
    out.under = {n: [calls[n], s] for n, s in seconds.items()}

    if not device:
        return out
    spans = np.array(sorted((e.time_range.start, e.time_range.end)
                            for e in device), dtype=np.float64)
    merged = [list(spans[0])]
    for s, t in spans[1:]:
        if s > merged[-1][1]:
            merged.append([s, t])
        else:
            merged[-1][1] = max(merged[-1][1], t)
    out.busy_s = sum(t - s for s, t in merged) * 1e-6

    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    out.device_ops = [[n, s] for n, s in sorted(by_name.items(),
                                                key=lambda kv: -kv[1])[:top]]

    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    t0 = starts.min() if len(starts) else merged[0][0]
    t1 = ends.max() if len(ends) else merged[-1][1]
    gaps = ([(t0, merged[0][0])]
            + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
            + [(merged[-1][1], t1)])
    idle: dict[str, float] = defaultdict(float)
    for s, t in gaps:
        if t <= s:
            continue
        mid = 0.5 * (s + t)
        inside = np.flatnonzero((starts <= mid) & (ends >= mid))
        label = (host[inside[np.argmax(starts[inside])]].name
                 if len(inside) else "no host op")
        idle[label] += (t - s) * 1e-6
    out.idle_gaps = [[n, s] for n, s in sorted(idle.items(),
                                               key=lambda kv: -kv[1])[:top]]
    return out
