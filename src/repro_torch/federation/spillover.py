"""Cost-aware spillover — the federation's cross-site load balancer.

Same sense/decide/act shape as the single-site
:class:`~repro_torch.autoscale.AutoscaleController`, but the actuator is a
*spill bridge* instead of a local worker: when a home resource class's
backlog outruns its drain rate (the backlog would take longer than
``horizon_s`` to clear at the observed consumption rate, measured with the
same :class:`~repro_torch.autoscale.RateTracker` primitive the autoscaler uses),
the controller raises a :class:`~repro_torch.federation.bridge.SiteBridgeAgent`
on that class topic at the cheapest remote site —
:meth:`~repro_torch.federation.SiteRouter.spill_score` weighs cold-start
(``Site.spinup_s``) vs slot-seconds (``Site.slot_cost``) vs WAN transfer
(link latency + input weight / bandwidth), and a partitioned site is
unreachable. Once the class has been idle for ``drain_idle_s`` the bridge
is gracefully drained (finishing its in-flight relays), so a burst borrows
remote capacity and hands it back.

Spillover and local autoscale compose: both watch the same class-topic
depth, so an autoscaled home pool absorbs what it can and the spillover
horizon decides when waiting for local elasticity is slower than paying
the WAN.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

from repro_torch.autoscale.rate import RateTracker
from repro_torch.core.scheduling import class_topic

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .bridge import SiteBridgeAgent
    from .cluster import FederatedCluster

log = logging.getLogger(__name__)

__all__ = ["SpilloverConfig", "SpilloverController"]

_LONG_AGO = -1e12


@dataclass(frozen=True)
class SpilloverConfig:
    """Policy knobs for backlog-driven cross-site spillover.

    ``horizon_s`` is the service-level target: spill when the class backlog
    would take longer than this to drain at the observed rate (or when
    there is backlog but no observed drain at all). ``min_backlog`` guards
    against spilling a trickle; ``est_run_s`` prices a task's slot-seconds
    in the spill score; ``max_bridges_per_class`` bounds how many spill
    bridges one class runs at once. Bridges are consumer-group *members*
    — partitions are what rebalance to them — so sustained pressure adds
    bridges one per cooldown (each scored independently; several may land
    on the same cheap site) exactly like the autoscaler adds workers."""

    classes: tuple[str, ...] = ("cpu",)
    horizon_s: float = 5.0
    min_backlog: int = 4
    interval_s: float = 0.25
    rate_window_s: float = 5.0
    cooldown_s: float = 1.0
    drain_idle_s: float = 1.0
    bridge_slots: int = 4
    max_bridges_per_class: int = 1
    est_run_s: float = 1.0
    history: int = 256


class _ClassState:
    """Controller-private runtime state of one spilling resource class."""

    def __init__(self, cfg: SpilloverConfig):
        self.consumed = RateTracker(cfg.rate_window_s, cfg.history)
        self.bridges: list["SiteBridgeAgent"] = []
        self.draining: list["SiteBridgeAgent"] = []
        self.last_spill = _LONG_AGO
        self.idle_since: float | None = None
        self.spills = 0
        self.releases = 0


class SpilloverController:
    """Watches the home class topics and borrows remote capacity.

    Built by :class:`~repro_torch.federation.FederatedCluster` when a
    :class:`SpilloverConfig` is passed; :meth:`tick` is public so tests can
    drive the loop deterministically (never :meth:`start` it then)."""

    def __init__(self, fed: "FederatedCluster", config: SpilloverConfig):
        self.fed = fed
        self.config = config
        known = set(fed.router.classes())
        for cls in config.classes:
            if cls not in known:
                raise ValueError(
                    f"spillover class {cls!r} is not a resource class of "
                    f"the federation's router (known: {sorted(known)})")
        self._classes = {cls: _ClassState(config)
                         for cls in config.classes}
        self._decisions: deque[dict] = deque(maxlen=128)
        self._group = f"{fed.prefix}-agents"
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        metrics = fed.home.broker.metrics
        self._c_spill = metrics.counter(
            "ksa_spillover_decisions_total",
            "Spillover decisions, by class, site and direction",
            labels=("cls", "site", "action"))
        self._g_bridges = metrics.gauge(
            "ksa_spill_bridges", "Active spill bridges per resource class",
            labels=("cls",))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SpilloverController":
        self._thread = threading.Thread(target=self._loop,
                                        name="spillover-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the control loop. Bridges stay registered on the facade —
        the federation's own teardown stops them."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # pragma: no cover - defensive
                log.exception("spillover tick failed")
            self._stop.wait(self.config.interval_s)

    # -- sense / decide / act ----------------------------------------------

    def tick(self) -> None:
        """One pass: sample depth/drain per class, raise a spill bridge at
        the cheapest reachable site under pressure, drain idle bridges."""
        now = time.time()
        cfg = self.config
        topics = {cls: class_topic(self.fed.prefix, cls)
                  for cls in self._classes}
        qs = self.fed.home.broker.queue_stats(self._group,
                                              list(topics.values()))
        with self._lock:
            self.ticks += 1
            for cls, st in self._classes.items():
                self._reap(st)
                stats = qs[topics[cls]]
                depth = stats["depth"]
                st.consumed.sample(now, stats["consumed"])
                rate = st.consumed.rate(now)
                in_flight = sum(b.stats()["in_flight"] for b in st.bridges)
                if depth > 0 or in_flight > 0:
                    st.idle_since = None
                elif st.idle_since is None:
                    st.idle_since = now
                pressure = depth >= cfg.min_backlog and (
                    rate <= 0.0 or depth / rate > cfg.horizon_s)
                if pressure and \
                        len(st.bridges) < cfg.max_bridges_per_class and \
                        now - st.last_spill >= cfg.cooldown_s:
                    self._spill(cls, st, depth, rate)
                elif st.bridges and st.idle_since is not None and \
                        now - st.idle_since >= cfg.drain_idle_s:
                    self._release(cls, st)
                self._g_bridges.labels(cls=cls).set(len(st.bridges))

    def _reap(self, st: _ClassState) -> None:
        for b in list(st.draining):
            if not b.alive:
                st.draining.remove(b)
                self.fed._forget_bridge(b)
        for b in list(st.bridges):
            if not b.alive:  # crashed / externally stopped
                st.bridges.remove(b)
                self.fed._forget_bridge(b)

    def _spill(self, cls: str, st: _ClassState, depth: int,
               rate: float) -> None:
        score, site = min(
            ((self.fed.router.spill_score(s,
                                          est_run_s=self.config.est_run_s),
              s) for s in self.fed.remote_sites),
            key=lambda pair: pair[0])
        if score == float("inf"):
            return  # every candidate site is partitioned
        bridge = self.fed._start_spill_bridge(
            site, cls, slots=self.config.bridge_slots)
        st.bridges.append(bridge)
        st.last_spill = time.time()
        st.spills += 1
        self._record(cls, site.name, "spill",
                     f"backlog {depth} vs drain {rate:.1f}/s "
                     f"(score {score:.3f})")

    def _release(self, cls: str, st: _ClassState) -> None:
        for b in list(st.bridges):
            st.bridges.remove(b)
            b.request_drain()
            st.draining.append(b)
            st.releases += 1
            self._record(cls, b.site.name, "release",
                         f"idle {self.config.drain_idle_s:.2f}s")
        st.idle_since = None

    def _record(self, cls: str, site: str, action: str, reason: str) -> None:
        self._decisions.append({"ts": time.time(), "cls": cls, "site": site,
                                "action": action, "reason": reason})
        self._c_spill.labels(cls=cls, site=site, action=action).inc()
        # blackbox: spill decisions are exactly the context a post-mortem
        # of a WAN incident needs next to the revocations
        self.fed.home.broker.blackbox.record(
            "spill_decision", cls=cls, site=site, action=action,
            reason=reason)
        log.info("spillover %s: %s -> %s (%s)", cls, action, site, reason)

    # -- observability -----------------------------------------------------

    def bridge_count(self, cls: str) -> int:
        with self._lock:
            return len(self._classes[cls].bridges)

    def status(self) -> dict:
        """The spillover slice of the ``GET /sites`` payload."""
        now = time.time()
        with self._lock:
            classes = {
                cls: {
                    "bridges": [{"site": b.site.name,
                                 "agent_id": b.agent_id}
                                for b in st.bridges],
                    "draining": [b.agent_id for b in st.draining],
                    "drain_rate": st.consumed.rate(now),
                    "spills": st.spills,
                    "releases": st.releases,
                }
                for cls, st in self._classes.items()}
            return {
                "ticks": self.ticks,
                "horizon_s": self.config.horizon_s,
                "classes": classes,
                "decisions": list(self._decisions),
            }
