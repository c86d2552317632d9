"""Crash flight recorder: a bounded blackbox ring of lifecycle events.

The :class:`FlightRecorder` lives on the broker (always on — event
appends are one deque op) and records the control-plane moments that
matter in a post-mortem: lease grants, revocations with reasons, agent
drains, spillover decisions, and journal repairs. On a *trigger
condition* — a revocation storm, a campaign entering FAILED, or an SLO
alert firing — it latches a **dump**: a snapshot of the recent event
ring plus optional caller-supplied context (lease table state, active
alerts). Dumps are bounded too, and served on ``GET /blackbox`` /
``KsaCluster.dump_blackbox()``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded blackbox of lifecycle events with auto-dump triggers.

    Parameters
    ----------
    max_events:
        Ring size for the raw event log.
    max_dumps:
        How many post-mortem dumps to retain (oldest evicted).
    storm_threshold / storm_window_s:
        ``record("revocation", ...)`` calls arriving at or above
        ``storm_threshold`` within ``storm_window_s`` auto-dump with
        trigger ``"revocation_storm"``.
    storm_cooldown_s:
        Minimum spacing between two storm auto-dumps, so one sustained
        storm produces one dump, not one per revocation.
    """

    def __init__(self, max_events: int = 2048, max_dumps: int = 8,
                 storm_threshold: int = 10, storm_window_s: float = 5.0,
                 storm_cooldown_s: float = 30.0) -> None:
        self._events: deque[dict[str, Any]] = deque(maxlen=max_events)
        self._dumps: deque[dict[str, Any]] = deque(maxlen=max_dumps)
        self._lock = threading.Lock()
        self._seq = 0
        self._counts: dict[str, int] = {}
        self.storm_threshold = int(storm_threshold)
        self.storm_window_s = float(storm_window_s)
        self.storm_cooldown_s = float(storm_cooldown_s)
        self._revocation_ts: deque[float] = deque(maxlen=max(1, storm_threshold))
        self._last_storm_dump = 0.0
        # context_fn is injected by the owning cluster/monitor so dumps
        # carry live state (lease stats, alerts) without the recorder
        # importing any of it
        self.context_fn: Callable[[], dict[str, Any]] | None = None

    # ------------------------------------------------------------- record

    def record(self, kind: str, **attrs: Any) -> None:
        """Append one lifecycle event; may latch a storm auto-dump."""
        now = time.time()
        ev = {"seq": 0, "ts": now, "kind": kind}
        ev.update(attrs)
        storm = False
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if kind == "revocation":
                self._revocation_ts.append(now)
                if (len(self._revocation_ts) >= self.storm_threshold
                        and now - self._revocation_ts[0]
                        <= self.storm_window_s
                        and now - self._last_storm_dump
                        >= self.storm_cooldown_s):
                    self._last_storm_dump = now
                    storm = True
        if storm:
            self.dump("revocation_storm")

    # -------------------------------------------------------------- reads

    def since(self, seq: int, limit: int = 512) -> tuple[int, list[dict]]:
        """Events with ``seq`` greater than the given watermark, oldest
        first, plus the new watermark — the publisher's drain API."""
        with self._lock:
            out = [e for e in self._events if e["seq"] > seq][:limit]
            new_seq = out[-1]["seq"] if out else max(seq, 0)
        return new_seq, out

    def events(self, limit: int = 256,
               kind: str | None = None) -> list[dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs[-limit:]

    # -------------------------------------------------------------- dumps

    def dump(self, trigger: str, context: dict[str, Any] | None = None,
             limit: int = 256) -> dict[str, Any]:
        """Latch a post-mortem snapshot of the recent ring and return it."""
        ctx = dict(context) if context else {}
        fn = self.context_fn
        if fn is not None:
            try:
                ctx.update(fn() or {})
            except Exception:  # noqa: BLE001 — a dump must never raise
                pass
        with self._lock:
            snap = {
                "trigger": trigger,
                "ts": time.time(),
                "seq": self._seq,
                "counts": dict(self._counts),
                "events": list(self._events)[-limit:],
                "context": ctx,
            }
            self._dumps.append(snap)
        return snap

    def dumps(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._dumps)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"events": len(self._events), "seq": self._seq,
                    "dumps": len(self._dumps), "counts": dict(self._counts)}

    def snapshot(self, limit: int = 256) -> dict[str, Any]:
        """The ``GET /blackbox`` payload: ring stats + recent events +
        retained dumps."""
        with self._lock:
            return {"seq": self._seq,
                    "counts": dict(self._counts),
                    "events": list(self._events)[-limit:],
                    "dumps": list(self._dumps)}
