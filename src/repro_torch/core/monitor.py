"""MonitorAgent — results collection, status tracking, watchdog, REST API.

Paper §3: "The MonitorAgent is, in fact, an optional component. Its main role
is to collect the results sent by each ClusterAgent and WorkerAgent upon task
completion. It also monitors the status of each submitted task, including
managing error messages through a separate flow with a designated topic. To
simplify user interaction, the MonitorAgent provides a web-based REST API."

Beyond the paper's baseline we implement the extension it names (§3): safe
handling of multiple concurrent attempts of the same task. Results are
**deduplicated and attempt-fenced** — the first DONE for a task wins, stale
attempts are recorded but ignored — which is what makes the watchdog's
resubmission (straggler mitigation) safe, i.e. exactly-once *effect* on top of
at-least-once delivery.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .broker import Broker, Consumer, Producer
from .lease import RevokeReason
from .messages import (CampaignEvent, ErrorMessage, ResultMessage,
                       StatusUpdate, TaskMessage, TaskStatus, topic_names)
from .scheduling import PlacementPolicy, ResourceClassPolicy
from .submitter import Submitter

log = logging.getLogger(__name__)

# Every endpoint the REST API serves, as advertised on ``GET /`` and in 404
# payloads. tests/test_obs.py lint-checks that the do_GET dispatch below
# never grows a route that is missing from this index.
ROUTES = (
    "/",
    "/tasks",
    "/tasks/<id>",
    "/campaigns",
    "/campaigns/<id>",
    "/summary",
    "/broker",
    "/autoscale",
    "/sites",
    "/metrics",
    "/trace/<task_id>",
    "/query",
    "/alerts",
    "/blackbox",
)

# /query accepts these aggregations (validated before hitting the store so
# a bad request is a structured 400, not a 500)
_QUERY_AGGS = ("latest", "rate", "quantile", "sum_by", "sum", "points")


@dataclass
class TaskEntry:
    task: TaskMessage | None = None
    status: str = TaskStatus.SUBMITTED.value
    attempt: int = 0
    agent_id: str = ""
    last_update: float = field(default_factory=time.time)
    result: dict | None = None
    result_attempt: int | None = None
    errors: list[dict] = field(default_factory=list)
    attempts_seen: int = 0
    duplicate_results: int = 0
    history: list[tuple[float, str, int]] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.result is not None

    def to_dict(self) -> dict:
        return {
            "status": self.status,
            "attempt": self.attempt,
            "agent_id": self.agent_id,
            "last_update": self.last_update,
            "done": self.done,
            "result": self.result,
            "result_attempt": self.result_attempt,
            "errors": self.errors[-3:],
            "duplicate_results": self.duplicate_results,
        }


class MonitorAgent:
    """Consumes ``jobs``/``done``/``error`` (and ``new``, to learn task
    definitions for resubmission) and maintains the task table.

    ``group_id`` semantics follow the paper: give each monitor its own group
    to broadcast every record to every monitor; share a group to load-balance
    result handling across monitors.
    """

    def __init__(self, broker: Broker, prefix: str = "ksa", *,
                 monitor_id: str = "monitor-0",
                 group_id: str | None = None,
                 task_timeout_s: float | None = None,
                 max_attempts: int = 3,
                 retry_on_error: bool = True,
                 retry_on_timeout: bool = True,
                 resubmit_campaign_tasks: bool = False,
                 placement: PlacementPolicy | None = None,
                 poll_interval_s: float = 0.05):
        self.broker = broker
        self.prefix = prefix
        self.topics = topic_names(prefix)
        self.monitor_id = monitor_id
        self.task_timeout_s = task_timeout_s
        self.max_attempts = max_attempts
        self.retry_on_error = retry_on_error
        self.retry_on_timeout = retry_on_timeout
        # pipeline-tagged tasks are retried by their PipelineAgent (which
        # enforces the stage RetryPolicy); a monitor resubmitting them too
        # would double every attempt. Opt in only for monitor-only setups.
        self.resubmit_campaign_tasks = resubmit_campaign_tasks
        self.placement = placement or ResourceClassPolicy()
        self.poll_interval_s = poll_interval_s
        self._submitter = Submitter(broker, prefix, placement=self.placement)
        gid = group_id or f"{prefix}-monitor-{monitor_id}"
        # task definitions (needed for watchdog resubmission) now live on the
        # per-resource-class topics; subscribe to all of them plus the bare
        # `-new` topic so flat/SingleTopicPolicy producers are seen too.
        task_topics = list(self.placement.topics(prefix))
        if self.topics["new"] not in task_topics:
            task_topics.append(self.topics["new"])
        self._consumer = Consumer(
            broker,
            [*task_topics, self.topics["jobs"], self.topics["done"],
             self.topics["error"], self.topics["campaigns"]],
            group_id=gid, member_id=f"{gid}-{monitor_id}")
        self._producer = Producer(broker)
        self._table: dict[str, TaskEntry] = {}
        # latest CampaignEvent snapshot per campaign (repro_torch.pipeline agents
        # publish these on PREFIX-campaigns; mirrored into /campaigns).
        self._campaigns: dict[str, dict] = {}
        # per-campaign journal tallies (the same topic carries the pipeline
        # agents' write-ahead event journal; the monitor does not fold it —
        # it surfaces durability/recovery status alongside the snapshots).
        self._journal: dict[str, dict] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._http: ThreadingHTTPServer | None = None
        # optional autoscale status source (wired by KsaCluster when an
        # AutoscaleController runs): a zero-arg callable returning the
        # /autoscale payload — per-pool membership, backlog history, and
        # the scaling decision log.
        self._autoscale_source: Any = None
        # federation attachments: /sites payload + federated /metrics text
        self._federation_source: Any = None
        self._federation_metrics: Any = None
        # telemetry plane attachments (attach_telemetry): the collector is
        # polled (and the alert engine evaluated) from the monitor loop;
        # /query, /alerts and /blackbox serve from them.
        self._telemetry_collector: Any = None
        self._alert_engine: Any = None
        self._telemetry_interval_s = 0.25
        self._next_telemetry = 0.0
        # scheduled journal compaction (attach_compaction): a periodic /
        # event-count trigger that invokes the pipeline's compact() from
        # this loop so operators never have to remember the maintenance.
        self._compact_cb: Any = None
        self._compact_interval_s: float | None = None
        self._compact_every_events: int | None = None
        self._last_compact = time.time()
        self._events_at_compact = 0
        # counters live in the broker's obs registry (one labeled family);
        # the bare attribute names below are read-only property views
        events = broker.metrics.counter(
            "ksa_monitor_events_total",
            "Per-monitor ingestion/watchdog events",
            labels=("monitor", "event"))
        self._c = {e: events.labels(monitor=monitor_id, event=e)
                   for e in ("results_handled", "resubmissions",
                             "revocations", "compactions", "legacy_forwards")}
        self._h_commit = broker.metrics.histogram(
            "ksa_result_commit_seconds",
            "Result publish -> monitor ingestion (commit) latency, "
            "per resource class", labels=("cls",))
        # per-class histogram children, interned once instead of a
        # labels() dict round trip per ingested result
        self._h_commit_cls: dict = {}
        # eviction sweeps take every group's lock; once per second is
        # plenty against the default multi-second session timeout —
        # sweeping at the 5ms poll tick just adds group-lock traffic. The
        # sweep quantum must stay a small fraction of the session timeout,
        # though: records stranded in a dead member's partitions are only
        # releasable after eviction, and every extra watchdog period they
        # stay stranded burns a resubmit out of the attempt budget.
        self._evict_interval_s = min(1.0, broker.session_timeout_s / 8.0)
        self._next_evict = 0.0

    # -- counter views (registry-backed; names predate repro_torch.obs) ----------

    @property
    def results_handled(self) -> int:
        return self._c["results_handled"].value

    @property
    def resubmissions(self) -> int:
        return self._c["resubmissions"].value

    @property
    def revocations(self) -> int:
        return self._c["revocations"].value

    @property
    def compactions(self) -> int:
        return self._c["compactions"].value

    @property
    def legacy_forwards(self) -> int:
        return self._c["legacy_forwards"].value

    def _task_class(self, task: TaskMessage | None) -> str:
        if task is None:
            return "flat"
        classify = getattr(self.placement, "classify", None)
        if classify is None:
            return "flat"
        try:
            return classify(task)
        except ValueError:
            return "flat"

    # -- ingestion --------------------------------------------------------------

    def _entry(self, task_id: str) -> TaskEntry:
        e = self._table.get(task_id)
        if e is None:
            e = TaskEntry()
            self._table[task_id] = e
        return e

    def _ingest(self, topic: str, value: dict) -> None:
        with self._lock:
            if topic == self.topics["new"] or \
                    topic.startswith(self.topics["new"] + "."):
                task = TaskMessage.from_dict(value)
                e = self._entry(task.task_id)
                e.task = task
                e.attempts_seen = max(e.attempts_seen, task.attempt + 1)
                # a resubmission supersedes older attempts
                if task.attempt >= e.attempt and not e.done:
                    e.attempt = task.attempt
                    e.status = TaskStatus.SUBMITTED.value
                    e.last_update = time.time()
                if topic == self.topics["new"] and not e.done:
                    # legacy/flat producer wrote to the bare `-new` topic,
                    # which no agent consumes under a class-routing policy —
                    # forward onto the class topic so the task actually runs
                    # (not a resubmission: same attempt, just re-addressed).
                    try:
                        target = self.placement.route(self.prefix, task)
                    except ValueError:
                        log.warning("task %s on %s is unroutable; leaving "
                                    "for the watchdog", task.task_id, topic)
                    else:
                        if target != topic:
                            now = time.time()
                            self.broker.spans.add(
                                task.task_id, "route", now, now,
                                attempt=task.attempt,
                                monitor=self.monitor_id, target=target)
                            self._producer.send(target, task.to_dict(),
                                                key=task.task_id)
                            self._c["legacy_forwards"].inc()
            elif topic == self.topics["jobs"]:
                upd = StatusUpdate.from_dict(value)
                e = self._entry(upd.task_id)
                e.history.append((upd.ts, upd.status, upd.attempt))
                if e.done:
                    return  # terminal result already accepted
                if upd.attempt < e.attempt:
                    return  # fenced: stale attempt
                e.attempt = upd.attempt
                e.status = upd.status
                e.agent_id = upd.agent_id or e.agent_id
                e.last_update = time.time()
            elif topic == self.topics["done"]:
                res = ResultMessage.from_dict(value)
                e = self._entry(res.task_id)
                if e.done:
                    e.duplicate_results += 1  # fenced duplicate (late attempt)
                    return
                e.result = res.result
                e.result_attempt = res.attempt
                e.status = TaskStatus.DONE.value
                e.agent_id = res.agent_id
                now = time.time()
                e.last_update = now
                self._c["results_handled"].inc()
                # commit span: result published -> accepted here (terminal)
                cls = self._task_class(e.task)
                h = self._h_commit_cls.get(cls)
                if h is None:
                    h = self._h_commit_cls[cls] = self._h_commit.labels(
                        cls=cls)
                h.observe(max(0.0, now - res.ts))
                self.broker.spans.add(res.task_id, "commit", res.ts, now,
                                      attempt=res.attempt,
                                      agent=res.agent_id,
                                      monitor=self.monitor_id)
            elif topic == self.topics["campaigns"]:
                if value.get("kind") == "journal":
                    # a write-ahead journal event (repro_torch.pipeline.state):
                    # tally it for the /campaigns recovery status instead of
                    # parsing it as a progress snapshot
                    cid = value.get("campaign_id", "")
                    j = self._journal.setdefault(
                        cid, {"events": 0, "last_seq": -1, "last_type": ""})
                    j["events"] += 1
                    seq = int(value.get("seq", -1))
                    if seq >= j["last_seq"]:
                        j["last_seq"] = seq
                        j["last_type"] = str(value.get("type", ""))
                    return
                ev = CampaignEvent.from_dict(value)
                prev = self._campaigns.get(ev.campaign_id)
                if prev is None or ev.ts >= prev.get("ts", 0.0):
                    self._campaigns[ev.campaign_id] = ev.to_dict()
            elif topic == self.topics["error"]:
                err = ErrorMessage.from_dict(value)
                e = self._entry(err.task_id)
                e.errors.append({"error": err.error, "attempt": err.attempt,
                                 "agent_id": err.agent_id})
                e.last_update = time.time()
                if not e.done and err.attempt >= e.attempt:
                    e.status = TaskStatus.ERROR.value
                    self._maybe_resubmit(e, reason="error")

    # -- watchdog / straggler mitigation --------------------------------------------

    def _maybe_resubmit(self, e: TaskEntry, reason: str) -> None:
        if e.task is None or e.done:
            return
        if e.task.campaign_id and not self.resubmit_campaign_tasks:
            return  # the owning PipelineAgent handles campaign-task retries
        if reason == "error" and not self.retry_on_error:
            return
        if reason in ("timeout", "stale") and not self.retry_on_timeout:
            return
        if e.attempts_seen >= self.max_attempts:
            log.warning("task %s exhausted %d attempts (%s)",
                        e.task.task_id, e.attempts_seen, reason)
            return
        # unified stop-path: if a live lease exists (a stale holder is — or
        # was — still on the hook for the task, e.g. a crashed agent that
        # never heartbeats again), Broker.revoke_lease cancels it, fences
        # its late verdict, and requeues the record in one atomic step.
        # Only when there is nothing to revoke (never leased, or the
        # agent-side watchdog already revoked and deliberately left the
        # requeue decision here) does the monitor produce a fresh attempt.
        lease = self.broker.lease_view(e.task.task_id)
        if lease is not None and lease["attempt"] > e.attempt:
            # a newer attempt than this table knows is already leased —
            # the requeue beat our ingestion; revoking (or resubmitting)
            # now would kill or duplicate healthy work. Let it run.
            e.last_update = time.time()
            return
        if reason != "error" and \
                self.broker.revoke_lease(e.task.task_id,
                                         RevokeReason.WATCHDOG):
            self._c["revocations"].inc()
            e.attempts_seen += 1
            # e.attempt is refreshed when the requeued record is ingested
            # (same attempt for a never-started lease, +1 for a running one)
            e.status = TaskStatus.SUBMITTED.value
            e.last_update = time.time()
            log.info("revoked lease of %s (reason=%s)", e.task.task_id,
                     reason)
            return
        nxt = TaskMessage.from_dict(e.task.to_dict())
        nxt.attempt = e.attempt
        self._submitter.resubmit(nxt)
        e.attempts_seen += 1
        e.attempt = nxt.attempt + 1
        e.status = TaskStatus.SUBMITTED.value
        e.last_update = time.time()
        self._c["resubmissions"].inc()
        log.info("resubmitted %s (attempt %d, reason=%s)",
                 e.task.task_id, e.attempt, reason)

    def _watchdog(self) -> None:
        if self.task_timeout_s is None:
            return
        now = time.time()
        with self._lock:
            for tid, e in self._table.items():
                if e.done or e.task is None:
                    continue
                if e.status in (TaskStatus.SUBMITTED.value,
                                TaskStatus.WAITING.value,
                                TaskStatus.RUNNING.value,
                                TaskStatus.TIMEOUT.value,
                                TaskStatus.CANCELLED.value,
                                TaskStatus.REVOKED.value):
                    # CANCELLED-without-result means the work did not finish
                    # (graceful agent shutdown mid-task) — recover it too.
                    # REVOKED normally supersedes itself (the revoker's
                    # requeued record arrives and resets the entry to
                    # SUBMITTED); one going *stale* means that redelivery
                    # never happened — _maybe_resubmit's newer-lease guard
                    # keeps this from duplicating a healthy requeue.
                    stale_for = now - e.last_update
                    deadline = self.task_timeout_s
                    if e.status == TaskStatus.SUBMITTED.value:
                        # no agent has accepted the record yet: it may be
                        # stranded in a dead member's partitions, which the
                        # broker only reassigns at session expiry. Waiting
                        # out that delivery horizon before resubmitting
                        # keeps the attempt budget for *executed* attempts
                        # instead of burning it on duplicates of a record
                        # that was never deliverable in the first place.
                        deadline += self.broker.session_timeout_s
                    if e.status == TaskStatus.TIMEOUT.value:
                        self._maybe_resubmit(e, reason="timeout")
                    elif stale_for > deadline and \
                            stale_for > self._deadline_for(e.task.task_id):
                        self._maybe_resubmit(e, reason="timeout")

    def _deadline_for(self, task_id: str) -> float:
        """The staleness deadline for one task: the uniform
        ``task_timeout_s`` unless the task's lease is stamped with a
        per-site WAN-tolerant deadline (a federation bridge holds it across
        a slow link — see :class:`~repro_torch.core.lease.LeaseTolerance`), in
        which case the stamped deadline wins. Never *tighter* than the
        uniform one: a remote site with a fast link still gets the
        configured grace. Only consulted for tasks the uniform check has
        already flagged stale, so the lease lookup is off the common
        path."""
        base = self.task_timeout_s
        lease = self.broker.lease_view(task_id)
        if lease is None:
            return base
        deadline = lease.get("deadline_s")
        if deadline is None:
            return base
        return max(base, deadline)

    # -- main loop -----------------------------------------------------------------

    def start(self) -> "MonitorAgent":
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.monitor_id}-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                batches = self._consumer.poll(timeout=self.poll_interval_s)
                for tp, recs in batches.items():
                    for rec in recs:
                        self._ingest(tp.topic, rec.value)
                if batches:
                    self._consumer.commit()
                self._watchdog()
                self._maybe_compact()
                self._telemetry_tick()
                now = time.time()
                if now >= self._next_evict:
                    self._next_evict = now + self._evict_interval_s
                    self.broker.evict_expired_members()
            except Exception:  # pragma: no cover - defensive
                log.exception("monitor %s loop error", self.monitor_id)
                time.sleep(self.poll_interval_s)
        self._consumer.close()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
        self.stop_http()

    # -- queries ----------------------------------------------------------------------

    def task(self, task_id: str) -> TaskEntry | None:
        with self._lock:
            return self._table.get(task_id)

    def tasks(self) -> dict[str, TaskEntry]:
        with self._lock:
            return dict(self._table)

    def pending(self) -> list[str]:
        with self._lock:
            return [t for t, e in self._table.items() if not e.done]

    def all_done(self, task_ids: list[str] | None = None) -> bool:
        with self._lock:
            ids = task_ids if task_ids is not None else list(self._table)
            return all(self._table.get(t) is not None and self._table[t].done
                       for t in ids)

    def wait_all(self, task_ids: list[str], timeout: float = 60.0,
                 poll: float = 0.02) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.all_done(task_ids):
                return True
            time.sleep(poll)
        return False

    def attach_autoscale(self, source: Any) -> None:
        """Register the autoscaler's status callable; served on
        ``GET /autoscale`` (and detachable with ``None``)."""
        with self._lock:
            self._autoscale_source = source

    def attach_federation(self, sites: Any, metrics: Any = None) -> None:
        """Register a :class:`~repro_torch.federation.FederatedCluster`'s status
        callables: ``sites()`` → the ``GET /sites`` payload (per-site
        queues, leases, links, spillover state), ``metrics()`` → the
        federated Prometheus exposition (every per-site registry merged
        with a ``site`` label) which then replaces the local registry on
        ``GET /metrics``. Detach with ``attach_federation(None)``."""
        with self._lock:
            self._federation_source = sites
            self._federation_metrics = metrics

    def sites(self) -> dict | None:
        with self._lock:
            source = self._federation_source
        return None if source is None else source()

    def metrics_text(self) -> str:
        """The ``/metrics`` exposition: federated (site-labelled, merged
        across sites) when a federation is attached, the local registry's
        render otherwise."""
        with self._lock:
            fed = self._federation_metrics
        if fed is not None:
            return fed()
        return self.broker.metrics.render()

    # -- scheduled journal compaction (ROADMAP open item) -----------------------

    def attach_compaction(self, cb: Any, *, interval_s: float | None = None,
                          every_events: int | None = None) -> None:
        """Run ``cb()`` (normally ``KsaCluster``'s pipeline ``compact()``)
        from the monitor loop whenever ``interval_s`` has elapsed or
        ``every_events`` new journal records have been ingested since the
        last compaction — scheduled maintenance instead of an operator
        chore. ``cb`` returning a truthy value counts as a compaction
        (surfaced as ``compactions`` in ``/summary``); returning ``None``
        (e.g. no pipeline agent started yet) does not."""
        with self._lock:
            self._compact_cb = cb
            self._compact_interval_s = interval_s
            self._compact_every_events = every_events
            self._last_compact = time.time()
            self._events_at_compact = self._journal_events()

    def _journal_events(self) -> int:
        return sum(j["events"] for j in self._journal.values())

    def _maybe_compact(self) -> None:
        with self._lock:
            cb = self._compact_cb
            if cb is None:
                return
            now = time.time()
            events = self._journal_events()
            due = False
            if self._compact_interval_s is not None and \
                    now - self._last_compact >= self._compact_interval_s:
                due = True
            if self._compact_every_events is not None and \
                    events - self._events_at_compact >= \
                    self._compact_every_events:
                due = True
            if not due:
                return
            self._last_compact = now
            self._events_at_compact = events
        try:
            result = cb()
        except Exception:  # pragma: no cover - defensive
            log.exception("monitor %s: scheduled compaction failed",
                          self.monitor_id)
            return
        if result:
            with self._lock:
                self._c["compactions"].inc()
            log.info("monitor %s: scheduled compaction truncated %s records",
                     self.monitor_id, result.get("truncated", "?")
                     if isinstance(result, dict) else "?")

    def autoscale(self) -> dict | None:
        with self._lock:
            source = self._autoscale_source
        return None if source is None else source()

    # -- telemetry plane ----------------------------------------------

    def attach_telemetry(self, collector: Any, engine: Any = None, *,
                         interval_s: float = 0.25) -> None:
        """Register the cluster's :class:`~repro_torch.obs.TelemetryCollector`
        (and optionally its :class:`~repro_torch.obs.AlertEngine`): the monitor
        loop polls the collector's feeds and evaluates the alert rules
        every ``interval_s``, and ``GET /query`` / ``GET /alerts`` serve
        from them. Detach with ``attach_telemetry(None)``."""
        with self._lock:
            self._telemetry_collector = collector
            self._alert_engine = engine
            self._telemetry_interval_s = interval_s
            self._next_telemetry = 0.0

    def _telemetry_tick(self) -> None:
        with self._lock:
            collector = self._telemetry_collector
            engine = self._alert_engine
            now = time.time()
            if collector is None or now < self._next_telemetry:
                return
            self._next_telemetry = now + self._telemetry_interval_s
        try:
            collector.poll()
            if engine is not None:
                engine.evaluate(now)
        except Exception:  # pragma: no cover - defensive
            log.exception("monitor %s telemetry tick failed",
                          self.monitor_id)

    def query(self, name: str, *, agg: str = "latest",
              labels: dict | None = None, window_s: float = 60.0,
              q: float | None = None, by: str | None = None) -> dict | None:
        """Run one :meth:`~repro_torch.obs.TimeSeriesStore.query` against the
        attached collector's store (None when no telemetry is attached;
        ``ValueError`` propagates for malformed requests)."""
        with self._lock:
            collector = self._telemetry_collector
        if collector is None:
            return None
        return collector.store.query(name, agg=agg, labels=labels,
                                     window_s=window_s, q=q, by=by)

    def alerts(self) -> dict | None:
        """The ``GET /alerts`` payload (None without an alert engine)."""
        with self._lock:
            engine = self._alert_engine
        return None if engine is None else engine.status()

    def blackbox(self) -> dict:
        """The ``GET /blackbox`` payload: the broker flight recorder's
        recent events and retained post-mortem dumps."""
        return self.broker.blackbox.snapshot()

    def campaigns(self) -> dict[str, dict]:
        """Latest per-campaign progress snapshots (per-stage done/in-flight/
        failed counters published by pipeline agents), each annotated with
        its journal tally (``journal.events`` / ``last_seq`` / ``last_type``)
        and ``recovered`` flag — the recovery status served on
        ``/campaigns``. A campaign seen only through journal events (its
        orchestrator died before publishing a snapshot) still appears, with
        ``state="JOURNALED"``: durable, awaiting ``KsaCluster.recover()``."""
        with self._lock:
            out: dict[str, dict] = {}
            for cid in set(self._campaigns) | set(self._journal):
                snap = self._campaigns.get(cid)
                d = dict(snap) if snap is not None else {
                    "campaign_id": cid, "state": "JOURNALED"}
                if cid in self._journal:
                    d["journal"] = dict(self._journal[cid])
                out[cid] = d
            return out

    def campaign(self, campaign_id: str) -> dict | None:
        with self._lock:
            return self.campaigns().get(campaign_id)

    def summary(self) -> dict:
        with self._lock:
            by_status: dict[str, int] = {}
            for e in self._table.values():
                by_status[e.status] = by_status.get(e.status, 0) + 1
            return {
                "tasks": len(self._table),
                "done": sum(e.done for e in self._table.values()),
                "by_status": by_status,
                "results_handled": self.results_handled,
                "resubmissions": self.resubmissions,
                "revocations": self.revocations,
                "compactions": self.compactions,
                "legacy_forwards": self.legacy_forwards,
                "duplicates_fenced": sum(e.duplicate_results
                                         for e in self._table.values()),
                "campaigns": len(self._campaigns),
                "journal_events": sum(j["events"]
                                      for j in self._journal.values()),
            }

    # -- REST API (paper §3: "a web-based REST API") ------------------------------------

    def start_http(self, port: int = 0) -> int:
        mon = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: Any) -> None:  # quiet
                pass

            def _send(self, code: int, payload: Any) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_text(self, code: int, body: str, content_type: str =
                           "text/plain; version=0.0.4; charset=utf-8") -> None:
                raw = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self) -> None:  # noqa: N802 - http.server API
                # any handler bug must surface as structured JSON, never
                # as a stack trace over a half-written response
                try:
                    self._route()
                except Exception as exc:  # pragma: no cover - defensive
                    log.exception("monitor %s: %s failed",
                                  mon.monitor_id, self.path)
                    try:
                        self._send(500, {"error": "internal error",
                                         "detail": str(exc)})
                    except Exception:
                        pass

            def _query_params(self) -> dict:
                """Parse /query parameters; raises ValueError with a
                user-facing message on anything malformed."""
                from urllib.parse import parse_qsl
                _, _, qs = self.path.partition("?")
                params = dict(parse_qsl(qs, keep_blank_values=True))
                name = params.pop("name", "")
                if not name:
                    raise ValueError("missing required parameter: name")
                agg = params.pop("agg", "latest")
                if agg not in _QUERY_AGGS:
                    raise ValueError(
                        f"unknown agg {agg!r} (one of {_QUERY_AGGS})")
                out: dict = {"name": name, "agg": agg}
                for key, cast in (("window_s", float), ("q", float)):
                    if key in params:
                        try:
                            out[key] = cast(params.pop(key))
                        except ValueError:
                            raise ValueError(
                                f"parameter {key} must be a number")
                if "by" in params:
                    out["by"] = params.pop("by")
                labels = {k[2:]: v for k, v in params.items()
                          if k.startswith("l.") and len(k) > 2}
                for k in list(params):
                    if k.startswith("l."):
                        params.pop(k)
                if params:
                    raise ValueError(
                        f"unknown parameters: {sorted(params)} (labels "
                        f"filter with l.<label>=<value>)")
                if labels:
                    out["labels"] = labels
                if agg == "quantile" and "q" not in out:
                    raise ValueError("agg=quantile requires q")
                if agg == "sum_by" and "by" not in out:
                    raise ValueError("agg=sum_by requires by=<label>")
                return out

            def _route(self) -> None:
                path, _, _ = self.path.partition("?")
                parts = [p for p in path.split("/") if p]
                if not parts:
                    self._send(200, {"service": "ksa-monitor",
                                     "monitor_id": mon.monitor_id,
                                     "endpoints": list(ROUTES)})
                elif parts == ["metrics"]:
                    self._send_text(200, mon.metrics_text())
                elif len(parts) == 2 and parts[0] == "trace":
                    spans = mon.broker.spans.trace(parts[1])
                    if not spans:
                        self._send(404, {"error": "no spans for task "
                                                  "(unknown, evicted, or "
                                                  "tracing disabled)"})
                    else:
                        self._send(200, {"task_id": parts[1],
                                         "spans": spans})
                elif parts == ["tasks"]:
                    with mon._lock:
                        self._send(200, {t: e.to_dict()
                                         for t, e in mon._table.items()})
                elif len(parts) == 2 and parts[0] == "tasks":
                    e = mon.task(parts[1])
                    if e is None:
                        self._send(404, {"error": "unknown task"})
                    else:
                        self._send(200, e.to_dict())
                elif parts == ["campaigns"]:
                    self._send(200, mon.campaigns())
                elif len(parts) == 2 and parts[0] == "campaigns":
                    c = mon.campaign(parts[1])
                    if c is None:
                        self._send(404, {"error": "unknown campaign"})
                    else:
                        self._send(200, c)
                elif parts == ["summary"]:
                    self._send(200, mon.summary())
                elif parts == ["broker"]:
                    self._send(200, mon.broker.stats())
                elif parts == ["autoscale"]:
                    payload = mon.autoscale()
                    if payload is None:
                        self._send(404, {"error": "no autoscaler attached"})
                    else:
                        self._send(200, payload)
                elif parts == ["sites"]:
                    payload = mon.sites()
                    if payload is None:
                        self._send(404, {"error": "no federation attached"})
                    else:
                        self._send(200, payload)
                elif parts == ["query"]:
                    try:
                        kw = self._query_params()
                    except ValueError as exc:
                        self._send(400, {"error": "bad query",
                                         "detail": str(exc)})
                        return
                    name = kw.pop("name")
                    try:
                        payload = mon.query(name, **kw)
                    except ValueError as exc:
                        self._send(400, {"error": "bad query",
                                         "detail": str(exc)})
                        return
                    if payload is None:
                        self._send(404, {"error": "no telemetry attached"})
                    else:
                        self._send(200, payload)
                elif parts == ["alerts"]:
                    payload = mon.alerts()
                    if payload is None:
                        self._send(404, {"error": "no alert engine "
                                                  "attached"})
                    else:
                        self._send(200, payload)
                elif parts == ["blackbox"]:
                    self._send(200, mon.blackbox())
                else:
                    self._send(404, {"error": "unknown endpoint",
                                     "endpoints": list(ROUTES)})

        self._http = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        t = threading.Thread(target=self._http.serve_forever,
                             name=f"{self.monitor_id}-http", daemon=True)
        t.start()
        return self._http.server_address[1]

    def stop_http(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
