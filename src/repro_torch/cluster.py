"""KsaCluster — the public facade over the KSA control plane.

Every example and benchmark used to hand-wire five components (Broker +
Submitter + Worker/Cluster agents + MonitorAgent + PipelineAgent) and had to
keep their prefixes, poll intervals, and placement policies consistent by
convention. ``KsaCluster`` owns that wiring: one object builds the broker and
topics, starts the agent pools (CPU workers, GPU workers, simulated Slurm
clusters), runs the monitor (+ optional REST API) and a lazily-started
pipeline agent, and tears everything down in reverse order on exit::

    from repro_torch.cluster import KsaCluster

    with KsaCluster(workers=2, gpu_workers=1,
                    slurm=dict(nodes=2, cpus_per_node=4)) as c:
        tid = c.submit("matrix", params={"n": 96}, timeout_s=60.0)
        c.wait_all([tid])
        print(c.result(tid))
        res = c.run_campaign(spec, items)       # DAG campaigns too
        print(c.status())                       # one aggregated snapshot

Placement is wired once: the facade passes the same
:class:`~repro_torch.core.scheduling.PlacementPolicy` to the submitter, every
agent, the monitor, and the pipeline agent, so GPU stages route to the GPU
pool end to end (the ParaFold split). Direct component wiring remains
available for tests and embedders, but is considered internal API.
"""
from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Any, Callable, Iterable, Mapping

from repro_torch.core.broker import Broker
from repro_torch.core.agents import AgentBase, ClusterAgent, WorkerAgent
from repro_torch.core.lease import RevokeReason
from repro_torch.core.messages import topic_names
from repro_torch.core.monitor import MonitorAgent, TaskEntry
from repro_torch.core.scheduling import (LeasePolicy, PlacementPolicy,
                                   ResourceClassPolicy, ResourceProfile)
from repro_torch.core.simslurm import SimSlurm
from repro_torch.core.submitter import Submitter
from repro_torch.obs import (AlertEngine, AlertRule, SloSpec, TelemetryCollector,
                       TelemetryPublisher, TimeSeriesStore)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.autoscale import AutoscaleConfig, AutoscaleController

_SLURM_KEYS = ("nodes", "cpus_per_node", "gpus_per_node", "mem_mb_per_node",
               "scheduler_interval_s", "spinup_s")

_CPU_DEFAULT = object()  # add_worker sentinel: "cpu-only profile sized to slots"


class KsaCluster:
    """Context-managed KSA deployment: broker, agent pools, monitor,
    pipeline orchestration, and one placement policy wired through all of
    them.

    Declarative pools: ``workers`` CPU-only workers (``worker_slots`` each),
    ``gpu_workers`` GPU-capable workers (``gpu_slots`` each), and ``slurm`` —
    a :class:`SimSlurm`, or a dict of SimSlurm kwargs (plus ClusterAgent
    kwargs such as ``oversubscribe``), or ``None``. More pools can be added
    after :meth:`start` with :meth:`add_worker` / :meth:`add_slurm`, removed
    gracefully with :meth:`drain_worker`, or managed *elastically* by
    passing ``autoscale=AutoscaleConfig(...)`` (see :mod:`repro_torch.autoscale`):
    a controller then grows/shrinks per-resource-class pools from the class
    topics' queue depth, and the monitor serves its decisions and backlog
    history on ``/autoscale``.

    ``broker=None`` creates (and owns, i.e. closes) an embedded broker;
    passing one shares it and leaves its lifecycle to the caller.
    """

    def __init__(self, *, prefix: str = "ksa",
                 broker: Broker | None = None,
                 placement: PlacementPolicy | None = None,
                 lease: LeasePolicy | None = None,
                 workers: int = 0, worker_slots: int = 2,
                 gpu_workers: int = 0, gpu_slots: int = 1,
                 slurm: SimSlurm | Mapping[str, Any] | None = None,
                 autoscale: "AutoscaleConfig | None" = None,
                 monitor: bool = True,
                 http: bool = False,
                 task_timeout_s: float | None = None,
                 max_attempts: int = 3,
                 pipeline_task_timeout_s: float | None = None,
                 pipeline_journal: bool = True,
                 max_in_flight_total: int | None = None,
                 compact_interval_s: float | None = None,
                 compact_every_events: int | None = None,
                 poll_interval_s: float = 0.01,
                 session_timeout_s: float | None = None,
                 default_partitions: int = 4,
                 partitioner: str = "hash",
                 obs: bool = True,
                 telemetry: bool = False,
                 telemetry_interval_s: float = 0.25,
                 slos: Iterable[SloSpec | AlertRule] = (),
                 site: str = "",
                 single_lock: bool = False,
                 debug_locks: bool = False,
                 agent_kw: Mapping[str, Any] | None = None,
                 monitor_kw: Mapping[str, Any] | None = None):
        self.prefix = prefix
        # federation: which site this control plane is ("" = standalone);
        # tags the owned broker so its stats and leases carry the site
        self.site = site
        self.placement = placement or ResourceClassPolicy()
        self._lease = lease
        self._spec = dict(workers=workers, worker_slots=worker_slots,
                          gpu_workers=gpu_workers, gpu_slots=gpu_slots,
                          slurm=slurm)
        self._autoscale_cfg = autoscale
        self._monitor_enabled = monitor
        self._http = http
        self.task_timeout_s = task_timeout_s
        self.max_attempts = max_attempts
        self.pipeline_task_timeout_s = pipeline_task_timeout_s
        self.pipeline_journal = pipeline_journal
        self.max_in_flight_total = max_in_flight_total
        # scheduled journal compaction (ROADMAP open item): with either knob
        # set, the monitor loop runs pipeline compact() on a period and/or
        # whenever that many new journal events have been ingested.
        self.compact_interval_s = compact_interval_s
        self.compact_every_events = compact_every_events
        self.poll_interval_s = poll_interval_s
        self.partitioner = partitioner
        self._agent_kw = dict(agent_kw or {})
        self._monitor_kw = dict(monitor_kw or {})

        self._owns_broker = broker is None
        if broker is None:
            # single_lock / debug_locks pass straight through to the owned
            # broker's data plane (legacy escape hatch / lock-order checks)
            broker_kw: dict[str, Any] = {"default_partitions": default_partitions,
                                         "obs": obs, "site": site,
                                         "single_lock": single_lock,
                                         "debug_locks": debug_locks}
            if session_timeout_s is not None:
                broker_kw["session_timeout_s"] = session_timeout_s
            broker = Broker(**broker_kw)
        self.broker = broker

        # telemetry plane (opt-in): periodic metric/span/event
        # snapshots on the durable PREFIX-telemetry topic, folded into a
        # queryable TimeSeriesStore and burn-rate-alerted against `slos`
        self._telemetry_enabled = telemetry
        self._telemetry_interval_s = telemetry_interval_s
        self._slos = tuple(slos)
        self.telemetry_store: TimeSeriesStore | None = None
        self.telemetry_publisher: TelemetryPublisher | None = None
        self.telemetry_collector: TelemetryCollector | None = None
        self.alert_engine: AlertEngine | None = None

        self.agents: list[AgentBase] = []
        self._slurms: list[SimSlurm] = []     # owned simulated clusters
        self.monitor: MonitorAgent | None = None
        self.autoscaler: "AutoscaleController | None" = None
        self.submitter: Submitter | None = None
        self._pipeline = None                 # lazy PipelineAgent
        self._http_port: int | None = None
        self._lock = threading.RLock()
        self._started = False
        self._stopped = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "KsaCluster":
        """Build and start every owned component. Raises on double-start —
        one facade is one deployment; make a second KsaCluster (sharing the
        broker) for a second deployment."""
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    f"KsaCluster(prefix={self.prefix!r}) was stopped; "
                    f"create a new instance")
            if self._started:
                raise RuntimeError(
                    f"KsaCluster(prefix={self.prefix!r}) already started")
            self._started = True
            try:
                self.submitter = Submitter(self.broker, self.prefix,
                                           placement=self.placement,
                                           partitioner=self.partitioner)
                # flight-recorder dumps carry live control-plane context
                self.broker.blackbox.context_fn = self._blackbox_context
                if self._telemetry_enabled:
                    self._start_telemetry()
                if self._monitor_enabled:
                    kw = dict(task_timeout_s=self.task_timeout_s,
                              max_attempts=self.max_attempts,
                              poll_interval_s=self.poll_interval_s,
                              placement=self.placement)
                    kw.update(self._monitor_kw)
                    self.monitor = MonitorAgent(self.broker, self.prefix,
                                                **kw).start()
                    if self._http:
                        self._http_port = self.monitor.start_http(0)
                    if self.compact_interval_s is not None or \
                            self.compact_every_events is not None:
                        self.monitor.attach_compaction(
                            self._auto_compact,
                            interval_s=self.compact_interval_s,
                            every_events=self.compact_every_events)
                    if self.telemetry_collector is not None:
                        self.monitor.attach_telemetry(
                            self.telemetry_collector, self.alert_engine,
                            interval_s=self._telemetry_interval_s)
                for _ in range(self._spec["workers"]):
                    self.add_worker(slots=self._spec["worker_slots"])
                for _ in range(self._spec["gpu_workers"]):
                    self.add_worker(slots=self._spec["gpu_slots"],
                                    profile=ResourceProfile(
                                        cpus=self._spec["gpu_slots"], gpus=1,
                                        mem_mb=1024 * self._spec["gpu_slots"]))
                if self._spec["slurm"] is not None:
                    self.add_slurm(self._spec["slurm"])
                if self._autoscale_cfg is not None:
                    from repro_torch.autoscale import AutoscaleController
                    self.autoscaler = AutoscaleController(
                        self, self._autoscale_cfg).start()
                    if self.monitor is not None:
                        self.monitor.attach_autoscale(self.autoscaler.status)
            except BaseException:
                # unwind whatever already started (threads, owned broker) —
                # a failed __enter__ never reaches __exit__
                self.stop()
                raise
        return self

    def _start_telemetry(self) -> None:
        """Build the telemetry plane: store + collector + alert engine +
        publisher, all sharing the durable ``PREFIX-telemetry`` topic.
        Called under the facade lock from :meth:`start`, before the
        autoscaler is built so its sensing lands in the same store."""
        topic = topic_names(self.prefix)["telemetry"]
        self.telemetry_store = TimeSeriesStore()
        self.telemetry_collector = TelemetryCollector(
            self.broker, topic, store=self.telemetry_store, site=self.site)
        rules = [r if isinstance(r, AlertRule) else AlertRule(slo=r)
                 for r in self._slos]
        self.alert_engine = AlertEngine(
            self.telemetry_store, rules, registry=self.broker.metrics,
            on_fire=self._on_alert_fire)
        self.telemetry_publisher = TelemetryPublisher(
            self.broker, topic, source=self.site or self.prefix,
            site=self.site, interval_s=self._telemetry_interval_s)
        self.telemetry_publisher.start()

    def _blackbox_context(self) -> dict:
        """Live control-plane context stitched into every flight-recorder
        dump: the unified lease ledger plus whatever alerts are firing."""
        ctx: dict[str, Any] = {"leases": self.broker.lease_stats()}
        engine = self.alert_engine
        if engine is not None:
            ctx["alerts"] = engine.active()
        return ctx

    def _on_alert_fire(self, rule: str, ev: dict) -> None:
        """Alert-engine hook: a firing alert is a trigger condition — it
        is recorded as a lifecycle event and latches a post-mortem dump."""
        self.broker.blackbox.record(
            "alert", rule=rule, burn_long=ev.get("burn_long"),
            burn_short=ev.get("burn_short"), metric=ev.get("metric"))
        self.broker.blackbox.dump(f"alert:{rule}", {"evaluation": ev})

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful, idempotent teardown in reverse dependency order:
        autoscaler first (stop resizing pools), then the pipeline agent
        (stop emitting tasks), the agent pools (drain in-flight work so it
        is redelivered), monitor, owned Slurm simulators, and finally the
        broker if this facade created it."""
        with self._lock:
            if not self._started or self._stopped:
                self._stopped = True
                return
            self._stopped = True
            autoscaler = self.autoscaler
        if autoscaler is not None:
            autoscaler.stop(timeout=timeout)
        with self._lock:
            pipeline, agents = self._pipeline, list(self.agents)
            monitor, slurms = self.monitor, list(self._slurms)
        if pipeline is not None:
            pipeline.stop(timeout=timeout)
        for a in agents:
            a.stop(timeout=timeout)
        publisher = self.telemetry_publisher
        if publisher is not None:
            # final flush before the monitor (and broker) go away
            publisher.stop(timeout=timeout)
        if monitor is not None:
            monitor.stop(timeout=timeout)
        for s in slurms:
            s.shutdown()
        if self._owns_broker:
            self.broker.close()

    def __enter__(self) -> "KsaCluster":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @property
    def started(self) -> bool:
        return self._started and not self._stopped

    def _require_started(self) -> None:
        if not self.started:
            raise RuntimeError(
                f"KsaCluster(prefix={self.prefix!r}) is not running — use "
                f"`with KsaCluster(...) as c:` or call start()")

    # -- agent pools -----------------------------------------------------------

    def add_worker(self, *, profile: ResourceProfile | None = _CPU_DEFAULT,
                   slots: int = 2, **kw: Any) -> WorkerAgent:
        """Start one in-process worker. By default the worker is CPU-only
        (GPU stages never route to it) with a memory budget of 1 GB per slot
        (mem-aware admission packs against it; default-sized tasks pack
        exactly one per slot); pass a GPU-capable or tainted
        :class:`ResourceProfile` for a model-owning/exclusive pool, or
        ``profile=None`` for a legacy universal worker that leases every
        class and skips memory admission."""
        self._require_started()
        if profile is _CPU_DEFAULT:
            profile = ResourceProfile(cpus=slots, mem_mb=1024 * slots)
        merged = dict(poll_interval_s=self.poll_interval_s, **self._agent_kw)
        merged.update(kw)
        agent = WorkerAgent(self.broker, self.prefix, slots=slots,
                            profile=profile, placement=self.placement,
                            **merged).start()
        with self._lock:
            self.agents.append(agent)
        return agent

    def add_slurm(self, slurm: SimSlurm | Mapping[str, Any] | None = None,
                  **kw: Any) -> ClusterAgent:
        """Attach a (simulated) Slurm cluster behind a ClusterAgent. Accepts
        a live :class:`SimSlurm` or a kwargs mapping — SimSlurm keys build the
        simulator (owned, shut down on exit); everything else (e.g.
        ``oversubscribe``) goes to the agent. The agent's resource profile is
        derived from the cluster hardware."""
        self._require_started()
        if slurm is None:
            slurm = {}
        if isinstance(slurm, Mapping):
            cfg = dict(slurm)
            cfg.update(kw)
            sim_kw = {k: cfg.pop(k) for k in _SLURM_KEYS if k in cfg}
            sim = SimSlurm(**sim_kw)
            with self._lock:
                self._slurms.append(sim)
            kw = cfg
        else:
            sim = slurm
        merged = dict(poll_interval_s=self.poll_interval_s, **self._agent_kw)
        merged.update(kw)
        agent = ClusterAgent(self.broker, sim, self.prefix,
                             placement=self.placement, **merged).start()
        with self._lock:
            self.agents.append(agent)
        return agent

    def drain_worker(self, agent: AgentBase, *,
                     timeout_s: float | None = None,
                     wait: bool = True) -> bool:
        """Gracefully remove one agent from the deployment (the manual
        counterpart of an autoscale scale-down): the agent stops its
        subscriptions (consumer-group leave — unread partitions rebalance
        to the survivors), requeues its deferred leases, lets in-flight
        tasks finish, then is deregistered. With ``wait=False`` the drain
        proceeds in the background (poll ``agent.state``) and a reaper
        deregisters the agent once it stops; otherwise blocks until drained
        and returns True, or False on ``timeout_s``."""
        agent.request_drain(timeout_s=timeout_s)
        if not wait:
            threading.Thread(
                target=self._await_drained, args=(agent, None),
                name=f"drain-reaper-{agent.agent_id}", daemon=True).start()
            return False
        deadline = None if timeout_s is None else \
            time.time() + timeout_s + 5.0
        return self._await_drained(agent, deadline)

    def _await_drained(self, agent: AgentBase,
                       deadline: float | None) -> bool:
        while agent.alive and not self._stopped:
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(0.01)
        if not agent.alive:
            self._forget_agent(agent)
        return not agent.alive

    def _forget_agent(self, agent: AgentBase) -> None:
        """Deregister a stopped agent (and shut down its owned SimSlurm)."""
        own_slurm = None
        with self._lock:
            if agent in self.agents:
                self.agents.remove(agent)
            slurm = getattr(agent, "slurm", None)
            if slurm is not None and slurm in self._slurms:
                self._slurms.remove(slurm)
                own_slurm = slurm
        if own_slurm is not None:
            own_slurm.shutdown()

    # -- flat task API ---------------------------------------------------------

    def submit(self, script: str, **kw: Any) -> str:
        self._require_started()
        return self.submitter.submit(script, **kw)

    def submit_batches(self, script: str, items: Any, **kw: Any) -> list[str]:
        self._require_started()
        return self.submitter.submit_batches(script, items, **kw)

    def wait_all(self, task_ids: list[str], timeout: float = 60.0,
                 poll: float = 0.02) -> bool:
        self._require_started()
        if self.monitor is None:
            raise RuntimeError("KsaCluster was built with monitor=False")
        return self.monitor.wait_all(task_ids, timeout=timeout, poll=poll)

    def task(self, task_id: str) -> TaskEntry | None:
        self._require_started()
        if self.monitor is None:
            raise RuntimeError("KsaCluster was built with monitor=False")
        return self.monitor.task(task_id)

    def result(self, task_id: str) -> dict | None:
        e = self.task(task_id)
        return None if e is None else e.result

    # -- campaigns (repro_torch.pipeline) --------------------------------------------

    @property
    def pipeline(self):
        """The facade's PipelineAgent, started on first use (campaigns are
        optional; flat deployments never pay for the extra consumer)."""
        self._require_started()
        with self._lock:
            if self._pipeline is None:
                from repro_torch.pipeline import PipelineAgent
                self._pipeline = PipelineAgent(
                    self.broker, self.prefix,
                    poll_interval_s=self.poll_interval_s,
                    default_task_timeout_s=self.pipeline_task_timeout_s,
                    placement=self.placement, lease=self._lease,
                    max_in_flight_total=self.max_in_flight_total,
                    journal=self.pipeline_journal).start()
            return self._pipeline

    def submit_campaign(self, spec: Any, items: Iterable | None = None, *,
                        params: Mapping[str, Any] | None = None,
                        campaign_id: str | None = None,
                        weight: float = 1.0) -> str:
        return self.pipeline.submit_campaign(spec, items, params=params,
                                             campaign_id=campaign_id,
                                             weight=weight)

    def run_campaign(self, spec: Any, items: Iterable | None = None, *,
                     params: Mapping[str, Any] | None = None,
                     weight: float = 1.0,
                     progress: Callable[[Any], None] | None = None,
                     timeout_s: float = 600.0):
        """Submit a campaign and block until its DAG drains; returns the
        :class:`~repro_torch.pipeline.driver.CampaignResult`."""
        from repro_torch.pipeline import run_campaign as _run
        return _run(spec, items, broker=self.broker, prefix=self.prefix,
                    params=params, agent=self.pipeline, weight=weight,
                    progress=progress, timeout_s=timeout_s)

    def recover(self, specs: Any, *, include_finished: bool = False
                ) -> list[str]:
        """Rebuild campaigns from the ``PREFIX-campaigns`` journal after an
        orchestrator crash (e.g. the previous KsaCluster process was
        ``kill -9``'d mid-campaign against a shared/durable broker).

        ``specs`` maps pipeline names to :class:`~repro_torch.pipeline.PipelineSpec`
        (or is an iterable of specs) — campaign specs are code (scripts,
        ``skip_when`` predicates), so they are re-supplied rather than
        journaled. Every live campaign is folded from its journal, repaired,
        and resumed: tasks with no terminal event are resubmitted on a
        journaled retry budget, results produced while no orchestrator was
        alive are absorbed, and duplicates are re-fenced against the replayed
        state. Returns the recovered campaign ids; follow with
        :meth:`wait_campaign` / :meth:`campaign_status` as usual.
        ``include_finished=True`` also rebuilds terminal campaigns so their
        results can be re-read."""
        self._require_started()
        return self.pipeline.recover(specs, include_finished=include_finished)

    def compact(self, specs: Any = None) -> dict:
        """Compact the campaign journal: snapshot terminal campaigns into
        single ``CampaignSnapshot`` records and truncate their per-event
        history off the ``PREFIX-campaigns`` topic, so a long-lived
        deployment serving a stream of campaigns stays bounded. With
        ``specs`` (name → :class:`~repro_torch.pipeline.PipelineSpec`), terminal
        campaigns already evicted from memory are folded from the journal
        and compacted too. See :meth:`~repro_torch.pipeline.PipelineAgent.compact`."""
        return self.pipeline.compact(specs)

    def _auto_compact(self) -> dict | None:
        """Scheduled-compaction callback run from the monitor loop; a no-op
        (None) until a pipeline agent exists — flat deployments never
        compact, and never pay for a pipeline consumer either."""
        with self._lock:
            pipeline = self._pipeline
        if pipeline is None or self._stopped:
            return None
        return pipeline.compact()

    # -- lease lifecycle --------------------------------------------------------

    def revoke(self, task_id: str, reason: str = RevokeReason.SCANCEL, *,
               requeue: bool | None = None) -> bool:
        """Operator-facing ``scancel`` analogue: revoke a task's live lease
        through :meth:`~repro_torch.core.broker.Broker.revoke_lease` — the holder
        is cancelled, its commit fenced, and the task requeued onto its
        class topic for another pool to pick up. ``requeue=None`` (default)
        applies the same split as every internal stop-path: flat tasks are
        broker-requeued; campaign tasks are only cancelled+fenced, and the
        owning PipelineAgent resubmits them on its journaled ``RetryPolicy``
        (a broker requeue behind its back would race its watchdog into a
        double execution). Returns False if the task holds no live lease
        (finished, or not yet leased)."""
        self._require_started()
        if requeue is None:
            view = self.broker.lease_view(task_id)
            requeue = view is None or view.get("campaign_id") is None
        return self.broker.revoke_lease(task_id, reason, requeue=requeue)

    def campaign_status(self, campaign_id: str):
        return self.pipeline.status(campaign_id)

    def wait_campaign(self, campaign_id: str, timeout: float = 60.0):
        return self.pipeline.wait(campaign_id, timeout=timeout)

    # -- observability ---------------------------------------------------------

    @property
    def http_port(self) -> int | None:
        """Port of the monitor REST API (``http=True``), else None."""
        return self._http_port

    def status(self) -> dict:
        """One aggregated snapshot: agents, monitor summary, campaigns,
        broker topic/group stats."""
        self._require_started()
        with self._lock:
            agents = [a.stats() for a in self.agents]
            pipeline = self._pipeline
        out: dict[str, Any] = {
            "prefix": self.prefix,
            "started": self.started,
            "agents": agents,
            "broker": self.broker.stats(),
            # unified stop-path telemetry: grants, completions, and
            # revocations by reason (watchdog / preempt / mem_overage /
            # drain / scancel) across every pool and campaign
            "leases": self.broker.lease_stats(),
        }
        if self.monitor is not None:
            out["monitor"] = self.monitor.summary()
        if pipeline is not None:
            out["campaigns"] = {c: s.to_dict()
                                for c, s in pipeline.campaigns().items()}
            out["preemptions"] = pipeline.preemptions
        if self.autoscaler is not None:
            out["autoscale"] = self.autoscaler.status()
        if self.alert_engine is not None:
            out["alerts"] = self.alert_engine.active()
        return out

    def query(self, name: str, *, agg: str = "latest",
              labels: dict[str, str] | None = None, window_s: float = 60.0,
              q: float | None = None, by: str | None = None) -> dict:
        """Query the telemetry time-series store — same semantics the
        monitor serves at ``GET /query``. ``agg`` is one of ``latest``,
        ``rate``, ``quantile`` (pass ``q``), ``sum_by`` (pass ``by``),
        ``sum`` or ``points``. Requires ``telemetry=True``; in a federation
        the home store carries ``site``-labelled series from every feed,
        so ``agg="sum_by", by="site"`` answers across sites."""
        store = self.telemetry_store
        if store is None:
            raise RuntimeError(
                "telemetry plane is off; construct KsaCluster(telemetry=True)")
        # poll eagerly so a query right after an event sees it without
        # waiting for the monitor's telemetry tick
        if self.telemetry_collector is not None:
            self.telemetry_collector.poll()
        return store.query(name, agg=agg, labels=labels,
                           window_s=window_s, q=q, by=by)

    def alerts(self) -> dict:
        """SLO alert-engine status: per-rule state, firing set, history."""
        if self.alert_engine is None:
            raise RuntimeError(
                "no alert engine; construct KsaCluster(telemetry=True)")
        if self.telemetry_collector is not None:
            self.telemetry_collector.poll()
        self.alert_engine.evaluate()
        return self.alert_engine.status()

    def dump_blackbox(self, trigger: str = "manual") -> dict:
        """Force a flight-recorder post-mortem dump and return it. Works
        with or without the telemetry plane — the blackbox rides on the
        broker and records lifecycle events unconditionally."""
        return self.broker.blackbox.dump(trigger)

    def metrics_text(self) -> str:
        """Prometheus text-format snapshot of the broker's metrics registry
        — the same payload the monitor serves at ``GET /metrics``."""
        return self.broker.metrics.render()

    def trace(self, task_id: str) -> list[dict]:
        """Full span chain for a task, sorted by start time: ``submit``,
        ``route``, ``grant`` (duration = queue wait), ``claim``, ``run``,
        ``revoke``, ``commit``, and ``journal`` spans across every attempt
        (attempts share one ``trace_id``, so a preempted-and-retried task
        yields one linked chain). Empty list if the task is unknown, its
        spans were evicted from the bounded store, or ``obs=False``."""
        return self.broker.spans.trace(task_id)

    def campaign_report(self, campaign_id: str) -> dict:
        """Per-stage critical-path breakdown for a campaign, joined from the
        span store: where wall-clock went — queue wait vs run time vs time
        burnt on pre-terminal attempts (retries/preemptions).

        Per stage (topological order): ``queue_s``/``run_s`` sum the
        terminal attempt's grant/run span durations across its tasks,
        ``retry_s`` sums wall time spent inside earlier attempts, ``retries``
        counts non-terminal attempts, ``wall_s`` is the stage's span extent
        (first span start → last span end). ``dominant_stage`` names the
        stage with the largest wall_s."""
        st = self.pipeline.status(campaign_id)
        stages: dict[str, dict] = {}
        for stage_name, task_ids in self.pipeline.stage_tasks(campaign_id):
            agg = {"tasks": len(task_ids), "traced": 0, "queue_s": 0.0,
                   "run_s": 0.0, "retry_s": 0.0, "retries": 0, "wall_s": 0.0}
            lo, hi = None, None
            for tid in task_ids:
                spans = self.broker.spans.trace(tid)
                if not spans:
                    continue
                agg["traced"] += 1
                lo = min(lo, spans[0]["start"]) if lo is not None else spans[0]["start"]
                end = max(s["end"] for s in spans)
                hi = max(hi, end) if hi is not None else end
                # terminal attempt = the attempt of the last run span (the
                # one whose result actually committed); everything before
                # it is retry overhead.
                runs = [s for s in spans if s["name"] == "run"]
                term = runs[-1]["attempt"] if runs else None
                for s in spans:
                    if s["name"] == "grant" and s.get("attempt") == term:
                        agg["queue_s"] += s["dur_s"]
                    elif s["name"] == "run" and s.get("attempt") == term:
                        agg["run_s"] += s["dur_s"]
                if term is not None:
                    earlier = [s for s in spans
                               if s["name"] in ("grant", "claim", "run", "revoke")
                               and s.get("attempt", term) < term]
                    if earlier:
                        agg["retry_s"] += (max(s["end"] for s in earlier)
                                           - min(s["start"] for s in earlier))
                        agg["retries"] += len({s["attempt"] for s in earlier})
            if lo is not None and hi is not None:
                agg["wall_s"] = hi - lo
            stages[stage_name] = agg
        dominant = max(stages, key=lambda n: stages[n]["wall_s"]) if stages else None
        return {
            "campaign_id": campaign_id,
            "pipeline": st.pipeline,
            "state": st.state,
            "preemptions": st.preemptions,
            "wall_s": st.elapsed_s(),
            "stages": stages,
            "dominant_stage": dominant,
        }
