"""AutoscaleController — the sense/act halves of the autoscale loop.

The paper's deployment is statically provisioned: one agent per cluster,
sized by hand (§4 runs three fixed pools for the AlphaKnot campaign). That
leaves the utilization gap ParaFold (arXiv:2111.06340) and APACE
(arXiv:2308.07954) both attack — CPU-stage backlog piles up while the GPU
pool idles, and vice versa. With per-resource-class topics the gap is
mechanically fixable: **queue depth per class is the demand signal**, and
the :class:`~repro_torch.cluster.KsaCluster` facade is the actuator.

Control loop, once per ``interval_s`` and per pool:

1. **sense** — :meth:`Broker.queue_stats` gives the class topic's depth and
   cumulative consumed count under the shared agents group (incremental
   counters, no record scans); pool agents' ``in_flight``/``deferred``
   stats complete the demand picture, and successive consumed samples give
   the drain rate;
2. **decide** — the pluggable :class:`~repro_torch.autoscale.policy.ScalingPolicy`
   (default :class:`~repro_torch.autoscale.policy.TargetBacklogPolicy`) maps the
   signal to a desired agent count, with hysteresis/cooldown/min/max inside
   the policy and a final clamp here;
3. **act** — grow through ``KsaCluster.add_worker`` / ``add_slurm`` (the
   same calls a human operator uses), shrink through the agents' graceful
   drain (:meth:`~repro_torch.core.agents.AgentBase.request_drain`): the draining
   agent leaves the consumer group, requeues its deferred leases, finishes
   its in-flight tasks, and is deregistered from the facade once stopped —
   no task lost, none double-run (asserted by knot-count parity in
   tests/test_autoscale.py).

Every decision is recorded (served on the monitor's ``/autoscale`` REST
endpoint together with per-pool backlog history), so scaling behaviour is
observable the same way task status is (§3's web-based REST API).
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any

from repro_torch.core.agents import AgentBase
from repro_torch.core.scheduling import class_topic
from repro_torch.obs import TimeSeriesStore

from .policy import AutoscaleConfig, AutoscaleError, PoolSignal, PoolSpec

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.cluster import KsaCluster

log = logging.getLogger(__name__)

_LONG_AGO = -1e12  # "never": makes every since_* duration effectively inf


class _PoolState:
    """Mutable runtime state of one elastic pool (controller-private)."""

    def __init__(self, spec: PoolSpec, history: int, rate_window_s: float):
        self.spec = spec
        self.agents: list[AgentBase] = []    # serving members
        self.draining: list[AgentBase] = []  # leaving members (finish work)
        self.last_scale_up = _LONG_AGO
        self.last_scale_down = _LONG_AGO
        self.idle_since: float | None = None
        # backlog/agents/in_flight/consumed samples live in the
        # controller's TimeSeriesStore (``src="autoscale"`` series), not
        # in per-pool rings — history and drain rate are store queries
        self.history_len = history
        self.rate_window_s = rate_window_s
        self.scale_ups = 0
        self.scale_downs = 0
        # when the class backlog last went 0 -> nonzero; the age of this
        # mark at the moment a grow is decided is the decision lag
        self.pressure_since: float | None = None


class AutoscaleController:
    """Backlog-driven elastic scaling of a :class:`KsaCluster`'s pools.

    Normally built by the facade (``KsaCluster(autoscale=cfg)``); the
    controller spawns each pool's ``min_agents`` on :meth:`start` and then
    adjusts within ``[min_agents, max_agents]`` as the per-class backlog
    moves. Direct construction against a started cluster is supported for
    tests and embedders.
    """

    def __init__(self, cluster: "KsaCluster", config: AutoscaleConfig,
                 store: TimeSeriesStore | None = None):
        self.cluster = cluster
        self.config = config
        # sensing is store-backed: samples land in the cluster's
        # telemetry TimeSeriesStore when the plane is on, or a private one
        # otherwise — either way a lookahead policy reads history from the
        # same query surface operators do, and swapping it in is a pure
        # policy change. The ``src="autoscale"`` label keeps these series
        # disjoint from registry-snapshot series folded by the collector.
        if store is None:
            store = getattr(cluster, "telemetry_store", None)
        if store is None:
            store = TimeSeriesStore(
                resolution_s=max(0.01, min(0.25, config.interval_s / 2)),
                max_buckets=max(64, 4 * config.history))
        self.store = store
        classes = getattr(cluster.placement, "classes", None)
        if classes is not None:
            known = set(classes())
            for p in config.pools:
                if p.cls not in known:
                    raise AutoscaleError(
                        f"pool class {p.cls!r} is not a resource class of "
                        f"the cluster's placement policy (known: "
                        f"{sorted(known)}); declare it via "
                        f"ResourceClassPolicy(extra_classes=...)")
        self._pools = {p.cls: _PoolState(p, config.history,
                                         config.rate_window_s)
                       for p in config.pools}
        self._decisions: deque[dict] = deque(maxlen=128)
        self._group = f"{cluster.prefix}-agents"
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0
        metrics = cluster.broker.metrics
        self._c_scaled = metrics.counter(
            "ksa_autoscale_decisions_total",
            "Scaling decisions recorded, by pool and direction",
            labels=("pool", "action"))
        self._h_tick = metrics.histogram(
            "ksa_autoscale_tick_seconds",
            "Sense/decide/act duration of one control-loop pass")
        self._h_lag = metrics.histogram(
            "ksa_autoscale_decision_lag_seconds",
            "Backlog appearing -> scale-up decision lag, per pool",
            labels=("pool",))
        self._g_agents = metrics.gauge(
            "ksa_pool_agents", "Serving agents per elastic pool",
            labels=("pool",))
        self._g_backlog = metrics.gauge(
            "ksa_pool_backlog", "Class-topic backlog per elastic pool",
            labels=("pool",))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "AutoscaleController":
        with self._lock:
            for pool in self._pools.values():  # provision floors up front
                if pool.spec.min_agents > len(pool.agents):
                    self._grow(pool, pool.spec.min_agents - len(pool.agents),
                               reason="min_agents floor")
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscale-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the control loop. Pool agents stay registered on the
        cluster — the facade's own teardown stops them."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # pragma: no cover - defensive
                log.exception("autoscale tick failed")
            self._stop.wait(self.config.interval_s)

    # -- sense / decide / act ------------------------------------------------

    def tick(self) -> None:
        """One control-loop pass over every pool (public for deterministic
        tests: drive ticks by hand with the loop thread never started)."""
        now = time.time()
        t_tick = time.perf_counter()
        topics = {cls: class_topic(self.cluster.prefix, cls)
                  for cls in self._pools}
        qs = self.cluster.broker.queue_stats(self._group,
                                             list(topics.values()))
        with self._lock:
            self.ticks += 1
            for cls, pool in self._pools.items():
                self._reap(pool)
                stats = qs[topics[cls]]
                backlog = stats["depth"]
                if backlog <= 0:
                    pool.pressure_since = None
                elif pool.pressure_since is None:
                    pool.pressure_since = now
                in_flight = 0
                for a in pool.agents:
                    s = a.stats()
                    in_flight += s["in_flight"] + s["deferred_pending"]
                lbl = {"pool": cls, "src": "autoscale"}
                self.store.ingest_many([
                    ("ksa_pool_consumed_total", lbl, now,
                     stats["consumed"], "counter"),
                    ("ksa_pool_backlog", lbl, now, backlog, "gauge"),
                    ("ksa_pool_agents", lbl, now, len(pool.agents),
                     "gauge"),
                    ("ksa_pool_in_flight", lbl, now, in_flight, "gauge"),
                ])
                if backlog > 0 or in_flight > 0:
                    pool.idle_since = None
                elif pool.idle_since is None:
                    pool.idle_since = now
                sig = PoolSignal(
                    cls=cls, backlog=backlog, in_flight=in_flight,
                    agents=len(pool.agents), slots=pool.spec.slots,
                    drain_rate=self.store.rate(
                        "ksa_pool_consumed_total", lbl,
                        pool.rate_window_s, now),
                    idle_for_s=(0.0 if pool.idle_since is None
                                else now - pool.idle_since),
                    since_scale_up_s=now - pool.last_scale_up,
                    since_scale_down_s=now - pool.last_scale_down)
                desired = self.config.policy.desired(sig, pool.spec)
                desired = max(pool.spec.min_agents,
                              min(pool.spec.max_agents, desired))
                if desired > sig.agents:
                    if pool.pressure_since is not None:
                        # the lag this pool's backlog waited for capacity;
                        # the episode is answered, so re-arm the mark
                        self._h_lag.labels(pool=cls).observe(
                            now - pool.pressure_since)
                        pool.pressure_since = None
                    self._grow(pool, desired - sig.agents,
                               reason=f"backlog {backlog} "
                                      f"({sig.backlog_per_slot:.1f}/slot)")
                elif desired < sig.agents:
                    self._shrink(pool, sig.agents - desired,
                                 reason=f"idle {sig.idle_for_s:.2f}s")
                self._g_agents.labels(pool=cls).set(len(pool.agents))
                self._g_backlog.labels(pool=cls).set(backlog)
        self._h_tick.observe(time.perf_counter() - t_tick)

    def _reap(self, pool: _PoolState) -> None:
        """Deregister drained (or crashed) members from the facade."""
        for a in list(pool.draining):
            if not a.alive:
                pool.draining.remove(a)
                self.cluster._forget_agent(a)
                log.info("pool %s: %s drained and deregistered",
                         pool.spec.cls, a.agent_id)
        for a in list(pool.agents):
            if not a.alive:  # crashed / externally stopped
                pool.agents.remove(a)
                self.cluster._forget_agent(a)

    def _grow(self, pool: _PoolState, n: int, *, reason: str) -> None:
        spec = pool.spec
        for _ in range(n):
            kw = dict(spec.agent_kw or {})
            if spec.kind == "slurm":
                agent = self.cluster.add_slurm(dict(spec.slurm or {}), **kw)
            else:
                agent = self.cluster.add_worker(
                    slots=spec.slots, profile=spec.resolve_profile(), **kw)
            pool.agents.append(agent)
        pool.last_scale_up = time.time()
        pool.scale_ups += n
        self._record(pool, "up", n, reason)

    def _shrink(self, pool: _PoolState, n: int, *, reason: str) -> None:
        # drain the least-loaded members first: their in-flight work (and
        # therefore the drain) finishes soonest
        victims = sorted(pool.agents,
                         key=lambda a: a.stats()["in_flight"])[:n]
        for a in victims:
            pool.agents.remove(a)
            a.request_drain(timeout_s=self.config.drain_timeout_s)
            pool.draining.append(a)
        pool.last_scale_down = time.time()
        pool.scale_downs += len(victims)
        self._record(pool, "down", len(victims), reason)

    def _record(self, pool: _PoolState, action: str, n: int,
                reason: str) -> None:
        d = {"ts": time.time(), "pool": pool.spec.cls, "action": action,
             "count": n, "agents": len(pool.agents),
             "draining": len(pool.draining), "reason": reason}
        self._decisions.append(d)
        self._c_scaled.labels(pool=pool.spec.cls, action=action).inc()
        log.info("autoscale %s: %s x%d -> %d agents (%s)", pool.spec.cls,
                 action, n, len(pool.agents), reason)

    # -- observability -------------------------------------------------------

    def pool_size(self, cls: str) -> int:
        with self._lock:
            return len(self._pools[cls].agents)

    @property
    def scale_ups(self) -> int:
        with self._lock:
            return sum(p.scale_ups for p in self._pools.values())

    @property
    def scale_downs(self) -> int:
        with self._lock:
            return sum(p.scale_downs for p in self._pools.values())

    def pool_history(self, cls: str, *,
                     limit: int | None = None) -> list[list]:
        """Store-backed ``[[ts, backlog, agents, in_flight], ...]`` rows
        for one pool, joined across the ``src="autoscale"`` series on the
        shared tick timestamp (downsampled to the store's bucket
        resolution)."""
        lbl = {"pool": cls, "src": "autoscale"}
        backlog = self.store.points("ksa_pool_backlog", lbl)
        agents = dict(self.store.points("ksa_pool_agents", lbl))
        in_flight = dict(self.store.points("ksa_pool_in_flight", lbl))
        rows = [[round(ts, 3), int(b), int(agents.get(ts, 0)),
                 int(in_flight.get(ts, 0))] for ts, b in backlog]
        if limit is not None:
            rows = rows[-limit:]
        return rows

    def status(self, *, history: int = 64) -> dict:
        """The ``/autoscale`` payload: per-pool membership, live signal
        components, recent backlog history, and the decision log."""
        now = time.time()
        with self._lock:
            pools: dict[str, Any] = {}
            for cls, pool in self._pools.items():
                lbl = {"pool": cls, "src": "autoscale"}
                hist = self.pool_history(
                    cls, limit=min(history, pool.history_len))
                pools[cls] = {
                    "kind": pool.spec.kind,
                    "min": pool.spec.min_agents,
                    "max": pool.spec.max_agents,
                    "slots": pool.spec.slots,
                    "agents": len(pool.agents),
                    "draining": len(pool.draining),
                    "agent_ids": [a.agent_id for a in pool.agents],
                    "backlog": hist[-1][1] if hist else 0,
                    "in_flight": hist[-1][3] if hist else 0,
                    "drain_rate": self.store.rate(
                        "ksa_pool_consumed_total", lbl,
                        pool.rate_window_s, now),
                    "scale_ups": pool.scale_ups,
                    "scale_downs": pool.scale_downs,
                    "history": hist,
                }
            return {
                "ticks": self.ticks,
                "interval_s": self.config.interval_s,
                "policy": type(self.config.policy).__name__,
                "pools": pools,
                "decisions": list(self._decisions),
                # unified stop-path telemetry: every scale-down drain's
                # requeues show up as reason="drain" revocations here,
                # alongside watchdog/preempt/mem_overage/scancel ones — one
                # ledger for every way the control plane takes work back
                "leases": self.cluster.broker.lease_stats(),
            }
