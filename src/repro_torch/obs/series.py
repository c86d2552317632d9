"""Bounded in-memory time-series store for the telemetry plane.

The :class:`TimeSeriesStore` is the query surface of the telemetry plane:
the :class:`~repro_torch.obs.telemetry.TelemetryCollector` folds metric samples
from the ``PREFIX-telemetry`` topic into it, and the monitor's ``/query``
endpoint, ``KsaCluster.query(...)``, the SLO engine, and the autoscale
controller's sensing all read from it.

Design points mirroring the rest of the repo:

- **Bounded everywhere.** Series are keyed by ``(name, labels)``; each
  series is a ring of *aligned* buckets (bucket index = ``ts //
  resolution_s``), so a series occupies O(max_buckets) regardless of
  sample rate — high-frequency publishers downsample into the same
  bucket instead of growing the ring.
- **Counter-friendly.** Buckets keep the *last* sample (cumulative
  counters), plus min/max/sum/count for gauges, so ``rate()`` can
  reproduce the autoscaler's ``RateTracker`` slope semantics (first
  usable sample inside the window vs. the newest sample) and
  ``quantile()`` has per-bucket samples to rank.
- **Label-filter queries.** All reads accept a partial ``labels`` filter
  (subset match), so ``rate("ksa_pool_consumed_total", {"pool": "gpu"})``
  and ``sum_by("site")`` across federated feeds are both one call.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Iterable

__all__ = ["TimeSeriesStore"]

_LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: dict[str, str] | None) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Series:
    """One bounded ring of aligned buckets.

    Each bucket is a mutable list ``[idx, ts, last, vmin, vmax, vsum,
    count]`` where ``ts`` is the timestamp of the newest sample folded
    into the bucket and ``last`` its value.
    """

    __slots__ = ("kind", "buckets")

    def __init__(self, kind: str, max_buckets: int) -> None:
        self.kind = kind
        self.buckets: deque[list] = deque(maxlen=max_buckets)

    def add(self, idx: int, ts: float, value: float) -> None:
        if self.buckets:
            cur = self.buckets[-1]
            if cur[0] == idx:
                if ts >= cur[1]:
                    cur[1], cur[2] = ts, value
                if value < cur[3]:
                    cur[3] = value
                if value > cur[4]:
                    cur[4] = value
                cur[5] += value
                cur[6] += 1
                return
            if idx < cur[0]:
                # late sample from a lagging feed — fold into the
                # matching bucket if it is still in the ring, else drop
                for b in reversed(self.buckets):
                    if b[0] == idx:
                        if value < b[3]:
                            b[3] = value
                        if value > b[4]:
                            b[4] = value
                        b[5] += value
                        b[6] += 1
                        return
                    if b[0] < idx:
                        break
                return
        self.buckets.append([idx, ts, value, value, value, value, 1])


class TimeSeriesStore:
    """Bounded per-series rings with aligned windows and rollup queries."""

    def __init__(self, resolution_s: float = 0.25, max_buckets: int = 4096,
                 max_series: int = 8192) -> None:
        if resolution_s <= 0:
            raise ValueError("resolution_s must be > 0")
        self.resolution_s = float(resolution_s)
        self.max_buckets = int(max_buckets)
        self.max_series = int(max_series)
        self._series: dict[tuple[str, _LabelKey], _Series] = {}
        self._lock = threading.Lock()
        self._dropped = 0

    # ------------------------------------------------------------- ingest

    def ingest(self, name: str, labels: dict[str, str] | None, ts: float,
               value: float, kind: str = "gauge") -> None:
        """Fold one sample into the ring for ``(name, labels)``."""
        key = (name, _label_key(labels))
        idx = int(ts // self.resolution_s)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    self._dropped += 1
                    return
                s = self._series[key] = _Series(kind, self.max_buckets)
            s.add(idx, ts, float(value))

    def ingest_many(self, samples: Iterable[tuple]) -> None:
        """Fold ``(name, labels, ts, value, kind)`` tuples in one lock hold."""
        with self._lock:
            for name, labels, ts, value, kind in samples:
                key = (name, _label_key(labels))
                s = self._series.get(key)
                if s is None:
                    if len(self._series) >= self.max_series:
                        self._dropped += 1
                        continue
                    s = self._series[key] = _Series(kind, self.max_buckets)
                s.add(int(ts // self.resolution_s), ts, float(value))

    # ------------------------------------------------------------ queries

    def _match(self, name: str,
               labels: dict[str, str] | None) -> list[tuple[_LabelKey, _Series]]:
        want = _label_key(labels)
        out = []
        for (n, lk), s in self._series.items():
            if n != name:
                continue
            if want and not set(want).issubset(lk):
                continue
            out.append((lk, s))
        return out

    def points(self, name: str, labels: dict[str, str] | None = None,
               window_s: float | None = None,
               now: float | None = None) -> list[tuple[float, float]]:
        """Time-ordered ``(ts, last)`` samples merged across matching
        series (one point per bucket per series)."""
        now = time.time() if now is None else now
        lo = (now - window_s) if window_s is not None else None
        with self._lock:
            matched = self._match(name, labels)
            pts = [(b[1], b[2]) for _, s in matched for b in s.buckets
                   if lo is None or b[1] >= lo]
        pts.sort(key=lambda p: p[0])
        return pts

    def latest(self, name: str, labels: dict[str, str] | None = None) -> float | None:
        """Newest sample value across matching series (``None`` if none)."""
        best = None
        with self._lock:
            for _, s in self._match(name, labels):
                if s.buckets:
                    b = s.buckets[-1]
                    if best is None or b[1] > best[0]:
                        best = (b[1], b[2])
        return best[1] if best else None

    def rate(self, name: str, labels: dict[str, str] | None = None,
             window_s: float = 60.0, now: float | None = None) -> float:
        """Per-second slope of a cumulative counter over ``window_s``,
        summed across matching series — the ``RateTracker`` semantics the
        autoscaler used to keep privately: slope between the first usable
        sample inside the window and the newest sample; 0.0 when fewer
        than two usable samples exist."""
        now = time.time() if now is None else now
        lo = now - window_s
        total = 0.0
        with self._lock:
            matched = self._match(name, labels)
            for _, s in matched:
                samples = [(b[1], b[2]) for b in s.buckets if b[1] >= lo]
                if len(samples) < 2:
                    continue
                (t0, v0), (t1, v1) = samples[0], samples[-1]
                if t1 <= t0:
                    continue
                total += max(0.0, (v1 - v0) / (t1 - t0))
        return total

    def quantile(self, name: str, q: float,
                 labels: dict[str, str] | None = None,
                 window_s: float = 60.0,
                 now: float | None = None) -> float | None:
        """Nearest-rank quantile over windowed bucket samples across
        matching series (``None`` when the window is empty)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("q must be in [0, 1]")
        vals = [v for _, v in self.points(name, labels, window_s, now)]
        if not vals:
            return None
        vals.sort()
        k = min(len(vals) - 1, max(0, int(q * len(vals) + 0.5) - 1))
        return vals[k]

    def sum_by(self, name: str, by: str,
               labels: dict[str, str] | None = None,
               window_s: float | None = None,
               now: float | None = None) -> dict[str, float]:
        """Sum of each matching series' newest windowed sample, grouped by
        the value of label ``by`` (series missing the label group under
        ``""``)."""
        now = time.time() if now is None else now
        lo = (now - window_s) if window_s is not None else None
        out: dict[str, float] = {}
        with self._lock:
            for lk, s in self._match(name, labels):
                if not s.buckets:
                    continue
                b = s.buckets[-1]
                if lo is not None and b[1] < lo:
                    continue
                group = dict(lk).get(by, "")
                out[group] = out.get(group, 0.0) + b[2]
        return out

    def sum(self, name: str, labels: dict[str, str] | None = None,
            window_s: float | None = None,
            now: float | None = None) -> float:
        """Sum of each matching series' newest windowed sample."""
        return float(sum(self.sum_by(name, "", labels, window_s,
                                     now).values()))

    # -------------------------------------------------------- query façade

    def query(self, name: str, agg: str = "latest",
              labels: dict[str, str] | None = None,
              window_s: float = 60.0, q: float | None = None,
              by: str | None = None,
              now: float | None = None) -> dict[str, Any]:
        """One-call dispatcher used by ``GET /query`` and
        ``KsaCluster.query(...)``. Raises ``ValueError`` on a malformed
        request (unknown ``agg``, missing ``q``/``by``) so HTTP callers
        can map it to a structured 400."""
        if agg == "latest":
            result: Any = self.latest(name, labels)
        elif agg == "rate":
            result = self.rate(name, labels, window_s, now)
        elif agg == "quantile":
            if q is None:
                raise ValueError("agg=quantile requires q")
            result = self.quantile(name, q, labels, window_s, now)
        elif agg == "sum_by":
            if not by:
                raise ValueError("agg=sum_by requires by=<label>")
            result = self.sum_by(name, by, labels, window_s, now)
        elif agg == "sum":
            result = sum(self.sum_by(name, "", labels, window_s,
                                     now).values())
        elif agg == "points":
            result = [[round(t, 6), v] for t, v in
                      self.points(name, labels, window_s, now)]
        else:
            raise ValueError(f"unknown agg {agg!r}")
        out = {"name": name, "agg": agg, "window_s": window_s,
               "result": result}
        if labels:
            out["labels"] = dict(labels)
        if q is not None:
            out["q"] = q
        if by:
            out["by"] = by
        return out

    # -------------------------------------------------------------- admin

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted({n for n, _ in self._series})

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"series": len(self._series),
                    "buckets": sum(len(s.buckets)
                                   for s in self._series.values()),
                    "resolution_s": self.resolution_s,
                    "dropped_series": self._dropped}
