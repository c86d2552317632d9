"""SLO specs and multi-window burn-rate alert rules over the store.

An :class:`SloSpec` names a telemetry series and an objective; an
:class:`AlertRule` wraps one with the SRE-workbook *multi-window* burn
test: the alert fires only when the **long** window burn rate and the
**short** window burn rate are both at or above the threshold (so a
sustained breach fires, a blip does not), and resolves as soon as the
short window drops back below (fast recovery detection). The
:class:`AlertEngine` evaluates every rule against the
:class:`~repro_torch.obs.series.TimeSeriesStore`, keeps a bounded transition
history, counts transitions as ``ksa_alerts_total{rule,state}``, and
invokes an ``on_fire`` hook — which the cluster wires to the
:class:`~repro_torch.obs.blackbox.FlightRecorder` so a firing alert latches a
post-mortem dump.

Burn-rate semantics per SLO ``kind``:

- ``"threshold"`` — gauge/latency series vs. an upper bound. With ``q``
  set, burn = ``quantile(metric, q, window) / objective`` (e.g. "queue
  wait p95 ≤ 2s"); without ``q``, burn = breach-ratio of windowed points
  over ``objective``, divided by the error ``budget`` fraction.
- ``"rate"`` — cumulative counter vs. an allowed events/second budget:
  burn = ``rate(metric, window) / objective`` (e.g. "≤ 0.5 lease
  revocations/s").
- ``"ratio"`` — two counters: burn = ``(rate(metric) /
  rate(total_metric)) / objective`` (e.g. "campaign task error ratio
  ≤ 5%"). A zero denominator reads as zero burn.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["SloSpec", "AlertRule", "AlertEngine"]


@dataclass(frozen=True)
class SloSpec:
    """What good looks like for one telemetry series."""

    name: str
    metric: str
    objective: float
    kind: str = "threshold"          # "threshold" | "rate" | "ratio"
    labels: dict[str, str] | None = None
    q: float | None = None           # quantile for kind="threshold"
    total_metric: str | None = None  # denominator for kind="ratio"
    budget: float = 0.01             # breach budget for plain thresholds

    def __post_init__(self) -> None:
        if self.kind not in ("threshold", "rate", "ratio"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if self.kind == "ratio" and not self.total_metric:
            raise ValueError("kind='ratio' requires total_metric")
        if self.objective <= 0:
            raise ValueError("objective must be > 0")

    def burn(self, store: Any, window_s: float,
             now: float | None = None) -> float:
        """Burn rate over one window: 1.0 means exactly at objective."""
        if self.kind == "rate":
            return store.rate(self.metric, self.labels, window_s,
                              now) / self.objective
        if self.kind == "ratio":
            total = store.rate(self.total_metric, self.labels, window_s, now)
            if total <= 0.0:
                return 0.0
            bad = store.rate(self.metric, self.labels, window_s, now)
            return (bad / total) / self.objective
        if self.q is not None:
            val = store.quantile(self.metric, self.q, self.labels,
                                 window_s, now)
            return 0.0 if val is None else val / self.objective
        pts = store.points(self.metric, self.labels, window_s, now)
        if not pts:
            return 0.0
        breach = sum(1 for _, v in pts if v > self.objective) / len(pts)
        return breach / self.budget if self.budget > 0 else float(breach > 0)


@dataclass(frozen=True)
class AlertRule:
    """Multi-window burn-rate test over one :class:`SloSpec`."""

    slo: SloSpec
    long_window_s: float = 60.0
    short_window_s: float = 10.0
    burn_threshold: float = 1.0
    name: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            object.__setattr__(self, "name", self.slo.name)
        if self.short_window_s > self.long_window_s:
            raise ValueError("short_window_s must be <= long_window_s")

    def evaluate(self, store: Any, now: float | None = None) -> dict[str, Any]:
        long_burn = self.slo.burn(store, self.long_window_s, now)
        short_burn = self.slo.burn(store, self.short_window_s, now)
        return {
            "rule": self.name,
            "metric": self.slo.metric,
            "kind": self.slo.kind,
            "objective": self.slo.objective,
            "burn_long": round(long_burn, 6),
            "burn_short": round(short_burn, 6),
            "threshold": self.burn_threshold,
            "breach": (long_burn >= self.burn_threshold
                       and short_burn >= self.burn_threshold),
            "recovered": short_burn < self.burn_threshold,
        }


class AlertEngine:
    """Evaluates rules against the store; tracks firing/resolved state."""

    def __init__(self, store: Any, rules: list[AlertRule] | tuple = (),
                 registry: Any | None = None,
                 on_fire: Callable[[str, dict], None] | None = None,
                 max_history: int = 256) -> None:
        self.store = store
        self.rules: list[AlertRule] = list(rules)
        self.on_fire = on_fire
        self._state: dict[str, dict[str, Any]] = {}
        self._history: deque[dict[str, Any]] = deque(maxlen=max_history)
        self._lock = threading.Lock()
        self._c_alerts = None
        if registry is not None:
            self._c_alerts = registry.counter(
                "ksa_alerts_total",
                "SLO alert transitions by rule and state.",
                ["rule", "state"])

    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            self.rules.append(rule)

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """Run every rule once; returns the full evaluation list."""
        now = time.time() if now is None else now
        with self._lock:
            rules = list(self.rules)
        fired: list[tuple[str, dict]] = []
        evals = []
        for rule in rules:
            ev = rule.evaluate(self.store, now)
            evals.append(ev)
            with self._lock:
                st = self._state.setdefault(
                    rule.name, {"state": "ok", "since": now, "firings": 0})
                prev = st["state"]
                if ev["breach"] and prev != "firing":
                    st.update(state="firing", since=now)
                    st["firings"] += 1
                    self._transition(rule.name, "firing", ev, now)
                    fired.append((rule.name, ev))
                elif prev == "firing" and ev["recovered"]:
                    st.update(state="resolved", since=now)
                    self._transition(rule.name, "resolved", ev, now)
                st["last"] = ev
        for name, ev in fired:
            if self.on_fire is not None:
                try:
                    self.on_fire(name, ev)
                except Exception:  # noqa: BLE001 — alerting must not kill
                    pass           # the monitor loop
        return evals

    def _transition(self, rule: str, state: str, ev: dict,
                    now: float) -> None:
        self._history.append({"rule": rule, "state": state, "ts": now,
                              "burn_long": ev["burn_long"],
                              "burn_short": ev["burn_short"]})
        if self._c_alerts is not None:
            self._c_alerts.labels(rule=rule, state=state).inc()

    def active(self) -> list[dict[str, Any]]:
        """Currently-firing alerts (the ``status()["alerts"]`` payload)."""
        with self._lock:
            return [dict(rule=name, **{k: v for k, v in st.items()})
                    for name, st in sorted(self._state.items())
                    if st["state"] == "firing"]

    def status(self) -> dict[str, Any]:
        """The ``GET /alerts`` payload: every rule's state + history."""
        with self._lock:
            return {
                "rules": [r.name for r in self.rules],
                "states": {name: dict(st)
                           for name, st in sorted(self._state.items())},
                "firing": [name for name, st in self._state.items()
                           if st["state"] == "firing"],
                "history": list(self._history),
            }
