"""PipelineAgent — a thin executor over the event-sourced campaign journal.

The agent is a *peer* of the MonitorAgent (§3): it subscribes to the
``PREFIX-done`` / ``PREFIX-error`` topics in its own consumer group (broadcast
copy — monitors and pipeline agents each see every record) and drives the
campaign state machine. Since the event-sourcing refactor it holds **no**
authoritative mutable progress of its own: every decision is appended as a
typed :mod:`repro_torch.pipeline.state` event to a write-ahead journal on the
``PREFIX-campaigns`` topic *before* the agent acts, then folded into the pure
:class:`~repro_torch.pipeline.state.CampaignState` reducer. An orchestrator
``kill -9`` therefore loses nothing a replay cannot rebuild — see
:meth:`recover`.

Responsibilities (unchanged semantics, now journal-backed):

* when an upstream task completes, emit next-stage ``TaskMessage``\\ s (map
  stages 1:1, join stages exactly once per barrier),
* **duplicate-result fencing**: the first result per task wins; late results
  from re-attempted tasks — including attempts replayed after a recovery —
  are counted and dropped, so a barrier can never double-fire,
* **backpressure**: per-stage ``max_in_flight`` bounds how many tasks of a
  stage are on the ``-new`` topic at once; the rest wait in a ready queue,
* **fair sharing**: a pluggable :class:`~repro_torch.core.scheduling.LeasePolicy`
  (FairShare weighted round-robin by default) decides whose ready task is
  submitted next; every grant is journaled as ``LeaseGranted``,
* **conditional edges**: ``Stage.skip_when`` short-circuits pointless tasks;
  skips are journaled (``StageSkipped``) so replay never re-runs predicates,
* **watchdog**: a task with no result after ``RetryPolicy.timeout_s`` is
  resubmitted with a bumped attempt; the retry budget is the journaled
  ``LeaseGranted`` count in ``CampaignState``, so resubmissions after a
  recovery never double-count attempts taken before the crash. Every
  resubmission first revokes the stale holder's lease
  (:meth:`~repro_torch.core.broker.Broker.revoke_lease`) so the old execution is
  cancelled and its late verdict fenced at the broker, not merely ignored,
* **preemptive fair share**: when the lease policy reports a severely
  over-share campaign while a peer with ready work is starved
  (:meth:`~repro_torch.core.scheduling.LeasePolicy.preempt`), the over-share
  campaign's longest-running lease is revoked
  (``reason="preempt"``, journaled as ``LeaseRevoked``) and requeued
  through the normal pump — bounded per campaign by
  ``RetryPolicy.max_preemptions``, without consuming the retry budget,
* progress snapshots are still published on ``PREFIX-campaigns`` for the
  MonitorAgent's ``/campaigns`` REST endpoint (interleaved with the journal;
  records carry a ``kind`` discriminator).

Recovery (:meth:`recover`): read the journal back via
:meth:`~repro_torch.core.broker.Broker.read_from`, fold each live campaign's
events, run the pure repair planners over any gap a crash left between
journal writes, re-register the campaign, and resubmit only tasks with no
terminal event — after an explicit replay read of ``-done`` absorbs results
produced while no orchestrator was alive, so finished work is never
re-executed and duplicates are re-fenced against the replayed state.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Any, Iterable, Mapping

from repro_torch.core.broker import Broker, Consumer, Producer
from repro_torch.core.lease import RevokeReason
from repro_torch.core.messages import (CampaignEvent, ErrorMessage, ResultMessage,
                                 TaskMessage, new_task_id, topic_names)
from repro_torch.core.scheduling import FairShare, LeasePolicy, PlacementPolicy
from repro_torch.core.submitter import Submitter

from .spec import PipelineSpec, Stage
from .state import (JOURNAL_KIND, CampaignSnapshot, CampaignState,
                    CampaignSubmitted, JournalEvent, LeaseGranted,
                    LeaseRevoked, StageSkipped, TaskDone, TaskFailed,
                    group_journal, plan_downstream, plan_sources,
                    snapshot_event)
from .status import CampaignStatus

log = logging.getLogger(__name__)


class PipelineError(RuntimeError):
    pass


class _CampaignRun:
    """Runtime envelope around one campaign's pure state: the spec (code —
    predicates and scripts are not journaled), wall-clock watchdog timers,
    and the completion latch. Everything else lives in ``self.state``."""

    def __init__(self, spec: PipelineSpec, campaign_id: str,
                 recovered: bool = False):
        self.spec = spec
        self.campaign_id = campaign_id
        self.state = CampaignState(spec, campaign_id)
        self.last_submit: dict[str, float] = {}
        self.completion = threading.Event()
        self.last_publish = 0.0
        self.recovered = recovered
        self.created_at = time.time()
        self.compacted_seq = -1  # state.seq at the last compact() snapshot

    @property
    def status(self) -> CampaignStatus:
        """A live view over the reducer state (stage objects are shared, so
        counters advance in place, matching the pre-refactor behaviour)."""
        st = CampaignStatus(campaign_id=self.campaign_id,
                            pipeline=self.state.pipeline,
                            state=self.state.state)
        st.stages = self.state.stages
        st.started_at = self.state.started_at or self.created_at
        st.finished_at = self.state.finished_at
        st.failure = self.state.failure
        st.preemptions = self.state.preemptions
        return st

    def max_preemptions(self) -> int:
        """The campaign-wide preemption bound: max over its stages'
        ``RetryPolicy.max_preemptions`` (0 = never preempt this campaign)."""
        return max((st.retry.max_preemptions
                    for st in self.spec.stages.values()), default=0)


class PipelineAgent:
    """Subscribes to ``-done``/``-error`` and advances registered campaigns.

    Multiple campaigns (even over different :class:`PipelineSpec`\\ s) can run
    concurrently through one agent; tasks from campaigns this agent does not
    own are ignored (unknown task_id), so several pipeline agents can share a
    prefix the way several MonitorAgents can (§3). ``journal=False`` disables
    the write-ahead journal (state is still folded from events in memory) —
    for benchmarks quantifying the append overhead, and embedders that accept
    losing recoverability.
    """

    def __init__(self, broker: Broker, prefix: str = "ksa", *,
                 agent_id: str | None = None,
                 poll_interval_s: float = 0.02,
                 default_task_timeout_s: float | None = None,
                 publish_interval_s: float = 0.25,
                 retain_finished: int | None = 32,
                 placement: PlacementPolicy | None = None,
                 lease: LeasePolicy | None = None,
                 max_in_flight_total: int | None = None,
                 journal: bool = True):
        self.broker = broker
        self.prefix = prefix
        self.topics = topic_names(prefix)
        self.agent_id = agent_id or f"pipeline-{id(self) & 0xffff:04x}"
        self.poll_interval_s = poll_interval_s
        self.default_task_timeout_s = default_task_timeout_s
        self.publish_interval_s = publish_interval_s
        # long-lived agents serve a stream of campaigns; keep only the most
        # recent `retain_finished` finished runs (None = keep all).
        self.retain_finished = retain_finished
        self._lease = lease or FairShare()
        self.max_in_flight_total = max_in_flight_total
        self.journal = journal
        # the journal must never age out under a broker-wide retention cap —
        # replay needs every event back to the oldest live campaign.
        broker.create_topic(self.topics["campaigns"], retention_records=None)
        self._submitter = Submitter(broker, prefix, placement=placement)
        self._producer = Producer(broker)
        gid = f"{prefix}-pipeline-{self.agent_id}"
        self._consumer = Consumer(
            broker, [self.topics["done"], self.topics["error"]],
            group_id=gid, member_id=f"{gid}-member")
        self._campaigns: dict[str, _CampaignRun] = {}
        self._task_index: dict[str, str] = {}  # task_id -> campaign_id
        # counters live in the broker's obs registry; the old attribute
        # names (events_journaled / preemptions) are property views below
        metrics = broker.metrics
        self._c_journal = metrics.counter(
            "ksa_journal_events_total",
            "Write-ahead campaign journal events appended",
            labels=("agent",)).labels(agent=self.agent_id)
        self._c_preempt = metrics.counter(
            "ksa_pipeline_preemptions_total",
            "Fair-share preemptive lease revocations issued",
            labels=("agent",)).labels(agent=self.agent_id)
        self._h_fold = metrics.histogram(
            "ksa_journal_fold_seconds",
            "Journal -> CampaignState fold time (recovery / compaction)")
        self._h_compact = metrics.histogram(
            "ksa_journal_compact_seconds",
            "Full journal compaction pass duration")
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._crashed = threading.Event()  # test hook: simulate kill -9
        self._thread: threading.Thread | None = None

    # -- counter views (registry-backed; names predate repro_torch.obs) ----------

    @property
    def events_journaled(self) -> int:
        return self._c_journal.value

    @property
    def preemptions(self) -> int:
        """Fair-share lease revocations issued (all runs)."""
        return self._c_preempt.value

    # -- journal / fold plumbing ----------------------------------------------

    def _emit(self, run: _CampaignRun, ev: JournalEvent) -> None:
        """Write-ahead: stamp, journal, then fold. Call with the lock held.
        Everything the agent does to campaign state goes through here."""
        ev = dataclasses.replace(ev, seq=run.state.seq + 1, ts=time.time())
        if self.journal:
            self._producer.send(self.topics["campaigns"], ev.to_dict(),
                                key=run.campaign_id)
            self._c_journal.inc()
        run.state.apply(ev)
        tid = getattr(ev, "task_id", "")
        if tid:  # planned/skipped tasks become addressable for fencing
            self._task_index[tid] = run.campaign_id
            self.broker.spans.add(tid, "journal", ev.ts, ev.ts,
                                  event=type(ev).__name__, seq=ev.seq,
                                  campaign=run.campaign_id,
                                  agent=self.agent_id)

    def _submit_record(self, run: _CampaignRun, task_id: str) -> None:
        """Grant a lease (journaled) and put the task on ``-new``."""
        rec = run.state.tasks[task_id]
        attempt = rec.attempts
        if attempt > 0:
            # a retry / regrant: revoke whatever lease a stale holder still
            # has on the previous attempt — the unified retry fencing. The
            # old execution is cancelled and its late verdict fenced at the
            # broker commit gate, not merely ignored at ingest; no requeue
            # (this very call is the resubmission).
            self.broker.revoke_lease(task_id, RevokeReason.WATCHDOG,
                                     requeue=False)
        self._emit(run, LeaseGranted(campaign_id=run.campaign_id,
                                     task_id=task_id, attempt=attempt))
        run.last_submit[task_id] = time.time()
        st = run.spec.stages[rec.stage]
        task = TaskMessage(
            task_id=task_id,
            script=st.script,
            params={**run.state.params, **dict(st.params), **rec.params},
            resources=st.resources,
            timeout_s=st.timeout_s,
            attempt=attempt,
            campaign_id=run.campaign_id,
            stage=rec.stage,
            dep_ids=list(rec.dep_ids),
            trace={"trace_id": task_id, "parent": run.campaign_id},
        )
        self._submitter.submit_task(task)

    # -- campaign submission -------------------------------------------------

    def submit_campaign(self, spec: PipelineSpec, items: Iterable | None = None,
                        *, params: Mapping[str, Any] | None = None,
                        campaign_id: str | None = None,
                        weight: float = 1.0) -> str:
        """Plan a campaign and submit its source-stage tasks. Returns the
        campaign id; progress via :meth:`status`, blocking via :meth:`wait`.
        ``weight`` sets this campaign's share of `-new` capacity under the
        agent's lease policy (FairShare: a weight-3 campaign drains three
        ready tasks for every one of a weight-1 peer)."""
        # a zero/negative weight starves the campaign under weighted round-
        # robin and NaN poisons every credit comparison in FairShare —
        # reject all of them here, at the API edge, with a clear error
        if not math.isfinite(weight) or weight <= 0:
            raise PipelineError(
                f"campaign weight must be a positive finite number "
                f"(got {weight!r})")
        # fail fast on unroutable stage resources (e.g. a label naming no
        # class) — raising here beats stalling mid-campaign in the loop
        for st in spec.topological():
            probe = TaskMessage(task_id=f"probe-{st.name}", script=st.script,
                                resources=st.resources)
            try:
                self._submitter.placement.route(self.prefix, probe)
            except ValueError as exc:
                raise PipelineError(
                    f"stage {st.name!r} is unroutable: {exc}") from exc
        items = list(items) if items is not None else []
        cid = campaign_id or new_task_id(f"camp-{spec.name}")
        with self._lock:
            if cid in self._campaigns:
                raise PipelineError(f"campaign {cid!r} already exists")
            run = _CampaignRun(spec, cid)
            self._campaigns[cid] = run
            self._emit(run, CampaignSubmitted(
                campaign_id=cid, pipeline=spec.name, items=tuple(items),
                params=dict(params or {}), weight=weight))
            for ev in plan_sources(run.state):
                self._emit(run, ev)
            self._pump_all()
            self._publish(run, force=True)
        return cid

    # -- backpressure / fair-share pump ---------------------------------------

    def _next_stage(self, run: _CampaignRun) -> Stage | None:
        """The first stage (topological order) with a ready task that fits
        under its ``max_in_flight`` bound, or None."""
        for st in run.spec.topological():
            if not run.state.ready[st.name]:
                continue
            bound = st.max_in_flight
            if bound is None or \
                    run.state.stages[st.name].in_flight < bound:
                return st
        return None

    def _pump_all(self) -> None:
        """Drain ready queues into ``-new`` capacity, one task at a time;
        the lease policy picks which campaign goes next (FairShare weighted
        round-robin by default). ``max_in_flight_total`` bounds the agent's
        outstanding tasks across all campaigns. Call with the lock held.

        The candidate set and the outstanding count are computed once and
        maintained incrementally: the lock is held throughout, so no other
        thread can make a campaign submittable mid-drain — candidates only
        ever shrink. This keeps a paper-scale fan-out (tens of thousands of
        source tasks) O(tasks), not O(tasks × campaigns × stages)."""
        outstanding = 0
        if self.max_in_flight_total is not None:
            outstanding = sum(
                ss.in_flight
                for r in self._campaigns.values() if not r.state.done
                for ss in r.state.stages.values())
        candidates = {cid: r.state.weight
                      for cid, r in self._campaigns.items()
                      if not r.state.done
                      and self._next_stage(r) is not None}
        while candidates:
            if self.max_in_flight_total is not None \
                    and outstanding >= self.max_in_flight_total:
                return
            cid = self._lease.select(candidates)
            run = self._campaigns[cid]
            st = self._next_stage(run)
            if st is None:  # safety net; normally pruned after submit
                del candidates[cid]
                continue
            self._submit_record(run, run.state.ready[st.name][0])
            outstanding += 1
            if self._next_stage(run) is None:
                del candidates[cid]

    # -- ingestion -------------------------------------------------------------

    def _ingest(self, topic: str, value: dict) -> None:
        if topic == self.topics["done"]:
            res = ResultMessage.from_dict(value)
            self._on_result(res)
        elif topic == self.topics["error"]:
            err = ErrorMessage.from_dict(value)
            self._on_error(err)

    def _on_result(self, res: ResultMessage) -> None:
        with self._lock:
            cid = self._task_index.get(res.task_id)
            if cid is None:
                return  # not one of ours (flat task or another agent's)
            run = self._campaigns[cid]
            rec = run.state.tasks[res.task_id]
            if rec.terminal or run.state.done:
                # fencing: duplicate results, late results for retry-exhausted
                # tasks, replayed attempts absorbed after a recovery, and
                # stragglers of an already-failed campaign never advance the
                # DAG (a FAILED verdict must stay final).
                run.state.count_duplicate(res.task_id)
                return
            self._emit(run, TaskDone(campaign_id=cid, task_id=res.task_id,
                                     result=res.result))
            self._advance(run, res.task_id)
            self._pump_all()
            self._finalize(run)
            self._publish(run)

    def _advance(self, run: _CampaignRun, task_id: str) -> None:
        """Plan (and journal) everything that follows a terminal task; skip
        cascades feed back into the worklist so an entire skipped subtree is
        planned in one pass."""
        queue = [task_id]
        while queue:
            tid = queue.pop(0)
            for ev in plan_downstream(run.state, tid):
                self._emit(run, ev)
                if isinstance(ev, StageSkipped):
                    queue.append(ev.task_id)
        self._finalize(run)

    def _on_error(self, err: ErrorMessage) -> None:
        with self._lock:
            cid = self._task_index.get(err.task_id)
            if cid is None:
                return
            run = self._campaigns[cid]
            rec = run.state.tasks[err.task_id]
            if rec.terminal or run.state.done:
                return
            if err.attempt < rec.attempts - 1:
                return  # fenced: an older attempt failing after a resubmit
            self._retry_or_fail(run, err.task_id, cause="error",
                                reason=f"error: {err.error}")

    # -- watchdog / retries ------------------------------------------------------

    def _retry_or_fail(self, run: _CampaignRun, task_id: str, *,
                       cause: str, reason: str) -> None:
        rec = run.state.tasks[task_id]
        st = run.spec.stages[rec.stage]
        # preemption regrants (journaled LeaseRevoked) are requeues, not
        # failures — they do not consume the retry budget
        if rec.attempts - rec.revokes < st.retry.max_attempts:
            if cause == "error":
                self._emit(run, TaskFailed(campaign_id=run.campaign_id,
                                           task_id=task_id, reason=reason,
                                           cause=cause, final=False))
            self._submit_record(run, task_id)
            log.info("campaign %s: resubmitted %s (attempt %d, %s)",
                     run.campaign_id, task_id, rec.attempts - 1, reason)
        else:
            # budget exhausted: revoke any still-running zombie so it stops
            # burning a slot and its eventual verdict is fenced at the broker
            self.broker.revoke_lease(task_id, RevokeReason.WATCHDOG,
                                     requeue=False)
            self._emit(run, TaskFailed(
                campaign_id=run.campaign_id, task_id=task_id,
                reason=(f"stage {rec.stage!r} task {task_id} exhausted "
                        f"{st.retry.max_attempts} attempts ({reason})"),
                cause=cause, final=True))
            self._finalize(run)
            log.warning("campaign %s FAILED: %s",
                        run.campaign_id, run.state.failure)
            # trigger condition: a campaign entering FAILED latches a
            # post-mortem blackbox dump with the events leading up to it
            self.broker.blackbox.record(
                "campaign_failed", campaign_id=run.campaign_id,
                task_id=task_id, reason=run.state.failure)
            self.broker.blackbox.dump(
                "campaign_failed",
                {"campaign_id": run.campaign_id,
                 "failure": run.state.failure})

    def _watchdog(self) -> None:
        now = time.time()
        with self._lock:
            for run in self._campaigns.values():
                if run.state.done:
                    continue
                for st in run.spec.topological():
                    timeout = st.retry.timeout_s or self.default_task_timeout_s
                    if timeout is None:
                        continue
                    for tid in run.state.by_stage[st.name]:
                        rec = run.state.tasks[tid]
                        if rec.terminal or rec.attempts == 0 \
                                or rec.revoke_pending:
                            # revoke-pending tasks are in the ready queue
                            # awaiting a regrant — the pump owns them, not
                            # the watchdog
                            continue
                        last = run.last_submit.get(tid, run.created_at)
                        if now - last > timeout and \
                                now - last > self._lease_deadline(tid,
                                                                  timeout):
                            self._retry_or_fail(
                                run, tid, cause="timeout",
                                reason=f"no result after {timeout:.1f}s")
                        if run.state.done:
                            return

    def _lease_deadline(self, task_id: str, base_timeout_s: float) -> float:
        """The effective no-result deadline for one task: the stage timeout,
        stretched to the lease's WAN-tolerant ``deadline_s`` when the task
        is held across a federation site (:class:`~repro_torch.core.lease.
        LeaseTolerance` stamps it at grant) — a stage relayed over a slow
        link is not a straggler just because the uniform timeout says so."""
        lease = self.broker.lease_view(task_id)
        if lease is None:
            return base_timeout_s
        deadline = lease.get("deadline_s")
        if deadline is None:
            return base_timeout_s
        return max(base_timeout_s, deadline)

    # -- preemptive fair share ---------------------------------------------------

    def _maybe_preempt(self) -> None:
        """Ask the lease policy whether some campaign is severely over its
        share while a peer with ready work is starved; if so, revoke the
        over-share campaign's longest-running lease through
        :meth:`Broker.revoke_lease` and journal it as ``LeaseRevoked`` so
        recovery replays the revocation. Revoke-then-journal: the revoke is
        the atomic authority (it returns False if the task completed
        concurrently — a finished task is never preempted), and a crash
        between the two degrades to a plain watchdog retry."""
        with self._lock:
            shares: dict[str, tuple[float, int, bool, bool]] = {}
            for cid, r in self._campaigns.items():
                if r.state.done:
                    continue
                in_flight = sum(ss.in_flight
                                for ss in r.state.stages.values())
                shares[cid] = (r.state.weight, in_flight,
                               self._next_stage(r) is not None,
                               r.state.preemptions < r.max_preemptions())
            if len(shares) < 2:
                return
            victim_cid = self._lease.preempt(shares)
            if victim_cid is None:
                return
            run = self._campaigns[victim_cid]
            cap = run.max_preemptions()
            if run.state.preemptions >= cap:
                return  # policy ignored the preemptible flag: hold the line
            # longest-running live lease of the victim campaign (RUNNING
            # beats GRANTED: a deferred lease holds no compute yet)
            candidates = [tid for tid, rec in run.state.tasks.items()
                          if rec.attempts > 0 and not rec.terminal
                          and not rec.revoke_pending]
            best, best_key = None, None
            for view in self.broker.live_leases(candidates):
                key = (0 if view["state"] == "RUNNING" else 1,
                       view.get("started_at") or view["granted_at"])
                if best_key is None or key < best_key:
                    best, best_key = view["task_id"], key
            if best is None:
                return
            if not self.broker.revoke_lease(best, RevokeReason.PREEMPT,
                                            requeue=False):
                return  # lost the race to a completion: nothing to take back
            self._emit(run, LeaseRevoked(campaign_id=victim_cid,
                                         task_id=best,
                                         reason=RevokeReason.PREEMPT))
            self._c_preempt.inc()
            log.info("campaign %s: preempted %s (%d/%d preemptions used)",
                     victim_cid, best, run.state.preemptions, cap)
            self._pump_all()
            self._publish(run)

    def _finalize(self, run: _CampaignRun) -> None:
        """Latch a terminal reducer state into the runtime side effects
        (completion event, forced snapshot, retention eviction)."""
        if not run.state.done or run.completion.is_set():
            return
        run.completion.set()
        self._publish(run, force=True)
        self._evict_finished()

    def _evict_finished(self) -> None:
        """Drop the oldest finished campaigns beyond ``retain_finished`` so a
        resident agent serving a campaign stream doesn't grow without bound.
        Callers must fetch results before the run ages out of the window (the
        journal keeps the events; :meth:`recover` with
        ``include_finished=True`` can rebuild an evicted campaign)."""
        if self.retain_finished is None:
            return
        finished = sorted((r for r in self._campaigns.values()
                           if r.state.done),
                          key=lambda r: r.state.finished_at or 0.0)
        for run in finished[:max(0, len(finished) - self.retain_finished)]:
            self.forget(run.campaign_id)

    def forget(self, campaign_id: str) -> None:
        """Release a finished campaign's task table and results."""
        with self._lock:
            run = self._campaigns.get(campaign_id)
            if run is None or not run.state.done:
                return
            for tid in run.state.tasks:
                self._task_index.pop(tid, None)
            del self._campaigns[campaign_id]
            self._lease.forget(campaign_id)

    # -- crash recovery ---------------------------------------------------------

    def recover(self, specs: Mapping[str, PipelineSpec] | Iterable[PipelineSpec],
                *, include_finished: bool = False) -> list[str]:
        """Reconstruct campaigns from the ``PREFIX-campaigns`` journal after
        an orchestrator crash. Returns the campaign ids registered.

        ``specs`` maps pipeline names to their :class:`PipelineSpec` (or is an
        iterable of specs) — the spec is code (scripts, ``skip_when``
        predicates) and is deliberately not journaled, so the caller must
        re-supply it; campaigns whose pipeline has no spec are skipped with a
        warning.

        For every campaign whose replayed state is still live:

        1. fold the journal into a fresh :class:`CampaignState` (duplicate
           and truncated-tail journal entries are deduped/dropped),
        2. run the pure repair planners to fill any gap a crash left between
           journal writes (a ``TaskDone`` whose downstream dispatch was never
           journaled),
        3. resubmit only tasks with **no terminal event**: previously leased
           tasks get a bumped, journaled attempt (counted against the same
           ``RetryPolicy`` budget the crashed agent was using — replayed
           retries are not re-counted); tasks already at their budget are
           left to the watchdog,
        4. never-leased ready tasks drain through the normal fair-share pump.

        Results that landed on ``-done`` while no orchestrator was alive are
        absorbed by an explicit replay read *before* deciding what to
        resubmit (a completed task is terminal, not resubmitted) — relying on
        the consumer loop alone would race it: a started agent may have
        polled and dropped those records as not-ours before the campaign was
        registered. Duplicates (e.g. the pre-crash attempt finishing after
        its post-recovery resubmission) are fenced against the replayed
        state; lost ``-error`` records degrade to watchdog timeouts.
        ``include_finished=True`` also registers campaigns whose journal
        folds to a terminal state (to re-read their results); they count
        toward ``retain_finished`` as usual.
        """
        if isinstance(specs, Mapping):
            by_name = dict(specs)
        else:
            by_name = {s.name: s for s in specs}
        records = [r.value
                   for r in self.broker.read_from(self.topics["campaigns"])]
        journals = group_journal(records)
        recovered: list[str] = []
        with self._lock:
            # every result the cluster has ever produced for this prefix;
            # read under the lock so nothing can slip between this scan and
            # campaign registration (the loop needs the lock to ingest)
            downtime_results = [
                ResultMessage.from_dict(r.value)
                for r in self.broker.read_from(self.topics["done"])]
            for cid, events in journals.items():
                if cid in self._campaigns:
                    continue  # already live on this agent
                # a compacted campaign's journal may start at its snapshot
                # (the CampaignSubmitted was truncated away) — both carry
                # the pipeline name needed to look up the spec
                sub = next((e for e in events
                            if isinstance(e, (CampaignSubmitted,
                                              CampaignSnapshot))), None)
                if sub is None:
                    log.warning("journal for %s has no CampaignSubmitted "
                                "or snapshot (truncated head?) — skipping",
                                cid)
                    continue
                spec = by_name.get(sub.pipeline)
                if spec is None:
                    log.warning("no spec supplied for pipeline %r — skipping "
                                "campaign %s", sub.pipeline, cid)
                    continue
                t_fold = time.perf_counter()
                state = CampaignState.fold(spec, cid, events)
                self._h_fold.observe(time.perf_counter() - t_fold)
                if state.done and not include_finished:
                    continue  # finished (possibly evicted) campaign
                run = _CampaignRun(spec, cid, recovered=True)
                run.state = state
                self._campaigns[cid] = run
                for tid in state.tasks:
                    self._task_index[tid] = cid
                self._repair(run)
                # absorb results produced while no orchestrator was alive:
                # first result per task wins, exactly like live ingestion
                for res in downtime_results:
                    rec = state.tasks.get(res.task_id)
                    if rec is None or rec.terminal or state.done:
                        # unknown, already folded from the journal (the
                        # usual case — not a duplicate), or moot
                        continue
                    self._emit(run, TaskDone(campaign_id=cid,
                                             task_id=res.task_id,
                                             result=res.result))
                    self._advance(run, res.task_id)
                now = time.time()
                for tid, rec in list(state.tasks.items()):
                    if rec.terminal or rec.attempts == 0 or rec.revoke_pending:
                        # revoke-pending: the journaled revocation already
                        # returned the task to its ready queue; the pump
                        # regrants it (replayed exactly like a completion)
                        continue
                    st = run.spec.stages[rec.stage]
                    if rec.attempts - rec.revokes < st.retry.max_attempts:
                        # no terminal event for this lease: resubmit with a
                        # bumped (journaled) attempt; the stale attempt's
                        # result, if it ever lands, is fenced as a duplicate
                        self._submit_record(run, tid)
                    else:
                        # budget already spent pre-crash; give the in-flight
                        # attempt a fresh watchdog window instead of failing
                        # the campaign on sight
                        run.last_submit[tid] = now
                self._finalize(run)
                self._publish(run, force=True)
                recovered.append(cid)
                log.info("recovered campaign %s (%s, %d events, state=%s)",
                         cid, sub.pipeline, len(events), state.state)
            self._pump_all()
        return recovered

    def _repair(self, run: _CampaignRun) -> None:
        """Re-run the pure planners over replayed state to journal anything a
        crash dropped between a fact event and its follow-up planning events.
        Both planners are guard-checked, so this is a no-op on a clean
        journal."""
        seq_before = run.state.seq
        for ev in plan_sources(run.state):
            self._emit(run, ev)
        for tid in [t for t, r in run.state.tasks.items() if r.terminal]:
            self._advance(run, tid)
        if run.state.seq != seq_before:
            # only journal repairs that actually re-emitted something —
            # a clean-journal no-op is not a lifecycle event
            self.broker.blackbox.record(
                "journal_repair", campaign_id=run.campaign_id,
                events=run.state.seq - seq_before)

    # -- journal compaction -----------------------------------------------------

    def compact(self, specs: Mapping[str, PipelineSpec]
                | Iterable[PipelineSpec] | None = None) -> dict:
        """Bound the ``PREFIX-campaigns`` journal (ROADMAP: the topic used to
        retain every event forever, since recovery needs history back to the
        oldest live campaign).

        Two steps, both crash-safe:

        1. **snapshot** — every terminal campaign is folded into a single
           :class:`~repro_torch.pipeline.state.CampaignSnapshot` journal record
           (write-ahead, like any other event). Registered campaigns are
           snapshotted directly; with ``specs`` supplied, journal-only
           terminal campaigns (evicted past ``retain_finished``, or another
           agent's finished runs whose pipeline we know) are folded from the
           journal and snapshotted too.
        2. **truncate** — each partition's prefix is deleted
           (:meth:`~repro_torch.core.broker.Broker.truncate_before`, the
           ``delete_records`` analogue) up to the first record still needed:
           a live/unknown campaign's journal event, or a compacted
           campaign's snapshot. Because records are keyed by campaign id, a
           compacted campaign's events that interleave *behind* a live
           campaign's first record survive until a later compact — prefix
           truncation is conservative, never lossy.

        ``recover()`` then folds snapshot-then-events: applying a snapshot
        wholesale-replaces whatever (possibly truncated) prefix preceded it,
        so a compacted terminal campaign rebuilds with full result parity
        (``include_finished=True``) and live campaigns are untouched.
        Returns ``{"campaigns": [...], "truncated": n, "retained": n}``.
        This scans the topic once — explicitly invoked maintenance, not the
        control loop (broker *stats* stay scan-free)."""
        if specs is None:
            by_name: dict[str, PipelineSpec] = {}
        elif isinstance(specs, Mapping):
            by_name = dict(specs)
        else:
            by_name = {s.name: s for s in specs}
        topic = self.topics["campaigns"]
        truncated = retained = 0
        t_compact = time.perf_counter()
        with self._lock:
            # 1a. snapshot registered terminal campaigns (write-ahead).
            # Re-running compact as periodic maintenance must be churn-free:
            # a campaign whose state is unchanged since its last snapshot
            # (run.compacted_seq) is only re-marked for retention.
            compacted: dict[str, int] = {}  # campaign_id -> snapshot seq
            for run in self._campaigns.values():
                if not run.state.done:
                    continue
                if run.compacted_seq != run.state.seq:
                    self._emit(run, snapshot_event(run.state))
                    run.compacted_seq = run.state.seq
                compacted[run.campaign_id] = run.compacted_seq
            # 1b. with specs: fold + snapshot journal-only terminal campaigns
            if by_name:
                journals = group_journal(
                    [r.value for r in self.broker.read_from(topic)])
                for cid, events in journals.items():
                    if cid in self._campaigns or cid in compacted:
                        continue
                    if len(events) == 1 and \
                            isinstance(events[0], CampaignSnapshot):
                        # already fully compacted: just retain the snapshot
                        compacted[cid] = events[0].seq
                        continue
                    sub = next((e for e in events
                                if isinstance(e, (CampaignSubmitted,
                                                  CampaignSnapshot))), None)
                    spec = by_name.get(sub.pipeline) if sub else None
                    if spec is None:
                        continue  # unknown pipeline: keep its journal as-is
                    t_fold = time.perf_counter()
                    state = CampaignState.fold(spec, cid, events)
                    self._h_fold.observe(time.perf_counter() - t_fold)
                    if not state.done:
                        continue
                    ev = dataclasses.replace(snapshot_event(state),
                                             seq=state.seq + 1,
                                             ts=time.time())
                    self._producer.send(topic, ev.to_dict(), key=cid)
                    self._c_journal.inc()
                    compacted[cid] = ev.seq
            # 2. per-partition prefix truncation up to the first keeper
            for p in range(self.broker.partitions_for(topic)):
                recs = self.broker.read_from(topic, partition=p)
                cut = None
                for rec in recs:
                    if self._compact_keep(rec.value, compacted):
                        cut = rec.offset
                        break
                if cut is None and recs:  # nothing to keep: drop everything
                    cut = recs[-1].offset + 1
                if cut is not None:
                    truncated += self.broker.truncate_before(
                        topic, cut, partition=p)
            retained = len(self.broker.read_from(topic))
        self._h_compact.observe(time.perf_counter() - t_compact)
        log.info("compacted %d campaign(s): %d records truncated, %d "
                 "retained", len(compacted), truncated, retained)
        return {"campaigns": sorted(compacted), "truncated": truncated,
                "retained": retained}

    def _compact_keep(self, value: Mapping[str, Any],
                      compacted: Mapping[str, int]) -> bool:
        """Must this ``-campaigns`` record survive the current compaction?"""
        cid = value.get("campaign_id", "")
        if value.get("kind") == JOURNAL_KIND:
            if cid not in compacted:
                return True  # live (or another agent's) campaign: keep all
            # only the freshly-written snapshot replaces the history; older
            # snapshots and per-event records are superseded
            return (value.get("type") == CampaignSnapshot.__name__
                    and int(value.get("seq", -1)) >= compacted[cid])
        # progress snapshots: droppable once their campaign is compacted
        return cid not in compacted

    # -- progress publishing (PREFIX-campaigns) -----------------------------------

    def _publish(self, run: _CampaignRun, force: bool = False) -> None:
        now = time.time()
        if not force and now - run.last_publish < self.publish_interval_s:
            return
        run.last_publish = now
        ev = CampaignEvent(
            campaign_id=run.campaign_id, pipeline=run.state.pipeline,
            state=run.state.state, agent_id=self.agent_id,
            stages={n: s.to_dict() for n, s in run.state.stages.items()},
            recovered=run.recovered, preemptions=run.state.preemptions)
        self._producer.send(self.topics["campaigns"], ev.to_dict(),
                            key=run.campaign_id)

    # -- queries -----------------------------------------------------------------

    def status(self, campaign_id: str) -> CampaignStatus:
        with self._lock:
            return self._campaigns[campaign_id].status

    def campaigns(self) -> dict[str, CampaignStatus]:
        with self._lock:
            return {c: r.status for c, r in self._campaigns.items()}

    def wait(self, campaign_id: str, timeout: float = 60.0) -> CampaignStatus:
        with self._lock:
            run = self._campaigns[campaign_id]
        run.completion.wait(timeout)
        return run.status

    def stage_tasks(self, campaign_id: str) -> list:
        """``[(stage_name, [task_id, ...]), ...]`` in topological order —
        the per-stage task map :meth:`repro_torch.cluster.KsaCluster.campaign_report`
        joins against the broker span store."""
        with self._lock:
            run = self._campaigns[campaign_id]
            by_stage = run.state.by_stage
            return [(st.name, list(by_stage.get(st.name, ())))
                    for st in run.spec.topological()]

    def results(self, campaign_id: str) -> dict[str, list]:
        """Per-stage results in task-creation order (completed tasks only)."""
        with self._lock:
            state = self._campaigns[campaign_id].state
            return {
                n: [state.tasks[t].result for t in tids
                    if state.tasks[t].result is not None]
                for n, tids in state.by_stage.items()
            }

    def final_result(self, campaign_id: str) -> Any:
        """The joined result: for a single-task terminal stage (the usual
        join barrier) the result dict itself, else {stage: [results...]}."""
        with self._lock:
            run = self._campaigns[campaign_id]
            state = run.state
            terms = run.spec.terminals()
            if len(terms) == 1 and len(state.by_stage[terms[0].name]) == 1:
                tid = state.by_stage[terms[0].name][0]
                return state.tasks[tid].result
            return {t.name: [state.tasks[tid].result
                             for tid in state.by_stage[t.name]]
                    for t in terms}

    def stats(self) -> dict:
        with self._lock:
            return {
                "agent_id": self.agent_id,
                "campaigns": len(self._campaigns),
                "running": sum(1 for r in self._campaigns.values()
                               if not r.state.done),
                "lease": type(self._lease).__name__,
                "weights": {c: r.state.weight
                            for c, r in self._campaigns.items()
                            if not r.state.done},
                "journal": self.journal,
                "events_journaled": self.events_journaled,
                "preemptions": self.preemptions,
                "recovered_campaigns": sum(
                    1 for r in self._campaigns.values() if r.recovered),
            }

    # -- main loop ------------------------------------------------------------------

    def start(self) -> "PipelineAgent":
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.agent_id}-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set() and not self._crashed.is_set():
            try:
                batches = self._consumer.poll(timeout=self.poll_interval_s)
                for tp, recs in batches.items():
                    for rec in recs:
                        self._ingest(tp.topic, rec.value)
                if batches:
                    self._consumer.commit()
                self._watchdog()
                with self._lock:
                    self._pump_all()
                self._maybe_preempt()
            except Exception:  # pragma: no cover - defensive
                log.exception("pipeline agent %s loop error", self.agent_id)
                time.sleep(self.poll_interval_s)
        # a crashed agent leaves its group membership to expire, as a dead
        # process would — only a graceful stop closes the consumer.
        if not self._crashed.is_set():
            self._consumer.close()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def crash(self) -> None:
        """Test hook: die abruptly — no drain, no group leave, and no further
        journal appends or task submissions (both producers are killed, as a
        dead process's would be). The journal already on the broker is all a
        recovering agent gets — exactly the ``kill -9`` contract."""
        self._crashed.set()
        self._producer.kill()
        self._submitter._producer.kill()
