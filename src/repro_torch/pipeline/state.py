"""Event-sourced campaign state — the journal schema and the pure reducer.

The PipelineAgent used to keep all DAG progress in mutable in-memory
structures, so an orchestrator crash mid-campaign orphaned every in-flight
task (the durability gap ROADMAP names; proteome-scale deployments such as
the Summit workflows, arXiv:2201.10024, and ParaFold, arXiv:2111.06340, show
multi-day campaigns are only viable when the *workflow state* is restartable,
not just the workers). This module makes campaign progress a fold over a
typed event log:

* **Journal events** — the write-ahead log entries appended to the
  ``PREFIX-campaigns`` topic *before* the agent acts on them:

  - :class:`CampaignSubmitted` — a campaign exists (items, params, weight),
  - :class:`StageDispatched` — one task of a stage was planned (ready to
    submit); carries the task's extra params (batch / upstream payload),
  - :class:`LeaseGranted` — a planned task was granted ``-new`` capacity by
    the lease policy (one event per submission, initial and retries — the
    retry budget is therefore journaled, not agent memory),
  - :class:`TaskDone` / :class:`TaskFailed` — a terminal (or, for
    ``final=False``, a to-be-retried) verdict for one task,
  - :class:`LeaseRevoked` — a running lease was taken back
    (``Broker.revoke_lease``; reason ``"preempt"`` for fair-share
    preemption) and the task returned to its stage's ready queue awaiting
    a regrant — replayed by recovery exactly like completions, so a crash
    between a revocation and its regrant loses nothing,
  - :class:`StageSkipped` — a conditional edge (``Stage.skip_when``)
    short-circuited one task; skips recorded here never re-run predicates
    during replay,
  - :class:`BarrierReleased` — a join barrier fired (followed by the join
    task's own ``StageDispatched`` / ``StageSkipped``),
  - :class:`CampaignSnapshot` — a full fold of one (terminal) campaign in a
    single record, appended by :meth:`PipelineAgent.compact`; applying it
    replaces everything folded before it, which is what lets compaction
    truncate the campaign's per-event history off the topic.

* :class:`CampaignState` — the pure reducer. ``fold(spec, events)`` rebuilds
  the exact campaign progress from a journal; ``apply`` is idempotent per
  event (duplicate suffixes from at-least-once delivery are no-ops), so
  ``fold(events) == fold(events + dup_suffix)``.

* **Decide functions** — :func:`plan_sources` and :func:`plan_downstream`
  are pure ``state -> [events]`` planners (the classic event-sourcing
  decide/apply split). The agent journals what they return and folds it;
  recovery re-runs them as a *repair pass* so a crash between journal writes
  (e.g. a ``TaskDone`` persisted but its downstream ``StageDispatched``
  lost) leaves no gap. Both are guarded so re-planning is idempotent.

Because the reducer is pure (no broker, no clock, no threads), DAG semantics
— barrier single-fire, skip cascades, retry budgets — are unit-testable
deterministically without any control-plane wiring.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

from .spec import PipelineSpec
from .status import StageStatus

JOURNAL_KIND = "journal"


# --------------------------------------------------------------------------
# Journal events (wire schema on PREFIX-campaigns)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JournalEvent:
    """Base journal entry. ``seq`` is the per-campaign monotonic sequence
    number (the dedupe key for at-least-once journal delivery); ``-1`` marks
    an event that has not been stamped by an agent yet."""

    campaign_id: str
    seq: int = -1
    ts: float = 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        data = {k: d.pop(k) for k in list(d)
                if k not in ("campaign_id", "seq", "ts")}
        return {"kind": JOURNAL_KIND, "type": type(self).__name__,
                "campaign_id": self.campaign_id, "seq": self.seq,
                "ts": self.ts, "data": data}


@dataclasses.dataclass(frozen=True)
class CampaignSubmitted(JournalEvent):
    pipeline: str = ""
    items: tuple = ()
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class StageDispatched(JournalEvent):
    stage: str = ""
    task_id: str = ""
    index: int = 0
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    dep_ids: tuple = ()


@dataclasses.dataclass(frozen=True)
class StageSkipped(JournalEvent):
    stage: str = ""
    task_id: str = ""
    index: int = 0
    dep_ids: tuple = ()


@dataclasses.dataclass(frozen=True)
class BarrierReleased(JournalEvent):
    stage: str = ""


@dataclasses.dataclass(frozen=True)
class LeaseGranted(JournalEvent):
    task_id: str = ""
    attempt: int = 0


@dataclasses.dataclass(frozen=True)
class LeaseRevoked(JournalEvent):
    """A granted/running lease was revoked (the task goes back to ready).
    Not a failure: the retry budget is untouched; ``reason`` follows
    :class:`repro_torch.core.lease.RevokeReason` (``"preempt"`` counts toward the
    campaign's ``RetryPolicy.max_preemptions`` bound)."""

    task_id: str = ""
    reason: str = "preempt"


@dataclasses.dataclass(frozen=True)
class TaskDone(JournalEvent):
    task_id: str = ""
    result: Mapping[str, Any] | None = None


@dataclasses.dataclass(frozen=True)
class TaskFailed(JournalEvent):
    task_id: str = ""
    reason: str = ""
    cause: str = "error"        # "error" | "timeout"
    final: bool = False         # True: retry budget exhausted -> FAILED


@dataclasses.dataclass(frozen=True)
class CampaignSnapshot(JournalEvent):
    """A full fold of one campaign's journal in a single record, written by
    :meth:`~repro_torch.pipeline.agent.PipelineAgent.compact` for terminal
    campaigns. Applying it **replaces** whatever state was folded so far, so
    ``fold(prefix + [snapshot])`` equals ``fold(full_history)`` even after
    the prefix has been truncated off the topic — the journal-compaction
    contract that keeps the ``-campaigns`` topic bounded over a stream of
    campaigns. ``tasks`` carries :class:`TaskRecord` dicts in per-stage
    creation order (results included, so an evicted campaign rebuilt from
    its snapshot still answers ``results()``)."""

    pipeline: str = ""
    state: str = "RUNNING"
    failure: str | None = None
    items: tuple = ()
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    weight: float = 1.0
    started_at: float = 0.0
    finished_at: float | None = None
    stages: Mapping[str, Mapping[str, Any]] = \
        dataclasses.field(default_factory=dict)
    tasks: tuple = ()
    joins_fired: tuple = ()
    preemptions: int = 0


def snapshot_event(state: "CampaignState") -> CampaignSnapshot:
    """Build the (unstamped) snapshot record folding ``state``."""
    stages = {}
    for n, ss in state.stages.items():
        d = ss.to_dict()
        for k in ("in_flight", "complete", "duplicates", "name", "script"):
            d.pop(k, None)  # derived / respawned / observability-only
        stages[n] = d
    tasks = tuple(state.tasks[tid].to_dict()
                  for n in state.by_stage for tid in state.by_stage[n])
    return CampaignSnapshot(
        campaign_id=state.campaign_id, pipeline=state.pipeline,
        state=state.state, failure=state.failure, items=tuple(state.items),
        params=dict(state.params), weight=state.weight,
        started_at=state.started_at, finished_at=state.finished_at,
        stages=stages, tasks=tasks,
        joins_fired=tuple(sorted(state.joins_fired)),
        preemptions=state.preemptions)


EVENT_TYPES: dict[str, type] = {
    cls.__name__: cls
    for cls in (CampaignSubmitted, StageDispatched, StageSkipped,
                BarrierReleased, LeaseGranted, LeaseRevoked, TaskDone,
                TaskFailed, CampaignSnapshot)
}


def is_journal_record(value: Mapping[str, Any]) -> bool:
    """Distinguish journal entries from CampaignEvent progress snapshots on
    the shared ``PREFIX-campaigns`` topic."""
    return value.get("kind") == JOURNAL_KIND and value.get("type") in EVENT_TYPES


def event_from_dict(value: Mapping[str, Any]) -> JournalEvent:
    cls = EVENT_TYPES[value["type"]]
    data = dict(value.get("data", {}))
    # msgpack round-trips tuples as lists; restore the frozen-field shapes
    for k in ("items", "dep_ids", "joins_fired", "tasks"):
        if k in data and isinstance(data[k], list):
            data[k] = tuple(data[k])
    return cls(campaign_id=value["campaign_id"], seq=int(value.get("seq", -1)),
               ts=float(value.get("ts", 0.0)), **data)


# --------------------------------------------------------------------------
# Task records + the reducer
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TaskRecord:
    """One planned task of one stage (all attempts share this record)."""

    task_id: str
    stage: str
    index: int                      # creation order within the stage
    params: dict = dataclasses.field(default_factory=dict)
    dep_ids: tuple = ()
    attempts: int = 0               # journaled submissions (LeaseGranted)
    done: bool = False
    failed: bool = False
    skipped: bool = False           # conditional edge: never submitted
    revokes: int = 0                # journaled LeaseRevoked events
    revoke_pending: bool = False    # revoked, back in ready, not regranted
    result: dict | None = None

    @property
    def terminal(self) -> bool:
        return self.done or self.failed or self.skipped

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class CampaignState:
    """Pure reducer over the journal of one campaign.

    Also carries the campaign-phase constants (``RUNNING`` / ``COMPLETED`` /
    ``FAILED``) that used to live in ``pipeline.status`` — one name for both
    the state machine and its vocabulary. Mutating entry points are
    :meth:`apply` (one event, idempotent) and :meth:`fold` (a whole journal);
    :meth:`count_duplicate` is the one non-journaled mutation (a fenced
    duplicate result is observability, not domain state — the counter resets
    to zero on replay).
    """

    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"

    def __init__(self, spec: PipelineSpec, campaign_id: str):
        self.spec = spec
        self.campaign_id = campaign_id
        self.pipeline = spec.name
        self.state = self.RUNNING
        self.failure: str | None = None
        self.started_at: float = 0.0
        self.finished_at: float | None = None
        self.items: list = []
        self.params: dict = {}
        self.weight: float = 1.0
        self.stages: dict[str, StageStatus] = {}
        self.tasks: dict[str, TaskRecord] = {}
        self.by_stage: dict[str, list[str]] = {}
        self.ready: dict[str, list[str]] = {}
        self.joins_fired: set[str] = set()
        self.preemptions = 0              # journaled reason="preempt" revokes
        self.seq = -1                     # highest applied journal seq
        # derived index: (upstream_task_id, stage) pairs already planned —
        # what makes plan_downstream() repair-idempotent without O(n^2) scans
        self._mapped: set[tuple[str, str]] = set()

    # -- queries -----------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.state in (self.COMPLETED, self.FAILED)

    @property
    def initialized(self) -> bool:
        return bool(self.stages)

    def stage_complete(self, name: str) -> bool:
        return self.stages[name].complete

    # -- the fold ----------------------------------------------------------

    @classmethod
    def fold(cls, spec: PipelineSpec, campaign_id: str,
             events: Iterable[JournalEvent]) -> "CampaignState":
        st = cls(spec, campaign_id)
        for ev in events:
            st.apply(ev)
        return st

    def apply(self, ev: JournalEvent) -> bool:
        """Fold one event; returns whether it changed state. Idempotent both
        by ``seq`` (stamped events at or below the high-water mark are
        skipped) and semantically (re-applying an unstamped event is a
        no-op), so a duplicated journal suffix folds to the same state."""
        if ev.seq >= 0:
            if ev.seq <= self.seq:
                return False
            self.seq = ev.seq
        if not self.initialized and \
                not isinstance(ev, (CampaignSubmitted, CampaignSnapshot)):
            # truncated head (journal compaction cut mid-history): events
            # before the campaign's creation record are uninterpretable —
            # skip them; the snapshot that follows restores state wholesale
            return False
        handler = getattr(self, f"_apply_{type(ev).__name__}")
        return handler(ev)

    def _apply_CampaignSubmitted(self, ev: CampaignSubmitted) -> bool:
        if self.initialized:
            return False
        self.pipeline = ev.pipeline or self.spec.name
        self.items = list(ev.items)
        self.params = dict(ev.params)
        self.weight = float(ev.weight)
        self.started_at = ev.ts
        expected = self.spec.expected_counts(len(self.items))
        for st in self.spec.topological():
            self.stages[st.name] = StageStatus(
                name=st.name, script=st.script, expected=expected[st.name])
            self.by_stage[st.name] = []
            self.ready[st.name] = []
        return True

    def _plan(self, stage: str, task_id: str, index: int, params: Mapping,
              dep_ids: Sequence[str], skipped: bool) -> TaskRecord | None:
        if task_id in self.tasks:
            return None
        rec = TaskRecord(task_id=task_id, stage=stage, index=index,
                         params=dict(params), dep_ids=tuple(dep_ids),
                         skipped=skipped)
        self.tasks[task_id] = rec
        self.by_stage[stage].append(task_id)
        for dep in rec.dep_ids:
            self._mapped.add((dep, stage))
        return rec

    def _apply_StageDispatched(self, ev: StageDispatched) -> bool:
        rec = self._plan(ev.stage, ev.task_id, ev.index, ev.params,
                         ev.dep_ids, skipped=False)
        if rec is None:
            return False
        self.ready[ev.stage].append(ev.task_id)
        return True

    def _apply_StageSkipped(self, ev: StageSkipped) -> bool:
        rec = self._plan(ev.stage, ev.task_id, ev.index, {}, ev.dep_ids,
                         skipped=True)
        if rec is None:
            return False
        self.stages[ev.stage].skipped += 1
        self._maybe_complete(ev.ts)
        return True

    def _apply_BarrierReleased(self, ev: BarrierReleased) -> bool:
        if ev.stage in self.joins_fired:
            return False
        self.joins_fired.add(ev.stage)
        return True

    def _apply_LeaseGranted(self, ev: LeaseGranted) -> bool:
        rec = self.tasks.get(ev.task_id)
        if rec is None or rec.terminal or ev.attempt < rec.attempts:
            return False
        rec.attempts = ev.attempt + 1
        ss = self.stages[rec.stage]
        if ev.attempt == 0:
            ss.submitted += 1
        else:
            ss.retried += 1
        self._clear_revoke_pending(rec)
        try:
            self.ready[rec.stage].remove(ev.task_id)
        except ValueError:
            pass
        return True

    def _apply_LeaseRevoked(self, ev: LeaseRevoked) -> bool:
        rec = self.tasks.get(ev.task_id)
        if rec is None or rec.terminal or rec.attempts == 0 \
                or rec.revoke_pending or self.done:
            return False
        rec.revokes += 1
        rec.revoke_pending = True
        ss = self.stages[rec.stage]
        ss.revoked += 1
        ss.revoke_pending += 1
        if ev.reason == "preempt":
            self.preemptions += 1
        # back of the ready queue: the lease pump regrants it under the
        # normal fair-share arbitration (journaled as a fresh LeaseGranted)
        self.ready[rec.stage].append(ev.task_id)
        return True

    def _clear_revoke_pending(self, rec: TaskRecord) -> None:
        if rec.revoke_pending:
            rec.revoke_pending = False
            ss = self.stages[rec.stage]
            ss.revoke_pending = max(0, ss.revoke_pending - 1)
            # a pending task sits in its ready queue awaiting a regrant; a
            # terminal verdict arriving first must pull it back out so the
            # pump can never grant a finished task
            try:
                self.ready[rec.stage].remove(rec.task_id)
            except ValueError:
                pass

    def _apply_TaskDone(self, ev: TaskDone) -> bool:
        rec = self.tasks.get(ev.task_id)
        if rec is None or rec.terminal or self.done:
            return False
        rec.done = True
        rec.result = dict(ev.result) if ev.result is not None else None
        self._clear_revoke_pending(rec)
        self.stages[rec.stage].done += 1
        self._maybe_complete(ev.ts)
        return True

    def _apply_TaskFailed(self, ev: TaskFailed) -> bool:
        rec = self.tasks.get(ev.task_id)
        if rec is None or rec.terminal:
            return False
        ss = self.stages[rec.stage]
        if ev.cause == "error":
            ss.errors += 1
        if ev.final:
            rec.failed = True
            self._clear_revoke_pending(rec)
            ss.failed += 1
            self.state = self.FAILED
            self.failure = ev.reason
            self.finished_at = ev.ts
        return True

    def _apply_CampaignSnapshot(self, ev: CampaignSnapshot) -> bool:
        """Wholesale restore: a snapshot *replaces* everything folded so far
        (which may be nothing, or a truncated — and therefore meaningless —
        prefix of the original history)."""
        self.pipeline = ev.pipeline or self.spec.name
        self.state = ev.state
        self.failure = ev.failure
        self.items = list(ev.items)
        self.params = dict(ev.params)
        self.weight = float(ev.weight)
        self.started_at = float(ev.started_at)
        self.finished_at = ev.finished_at
        self.stages = {}
        self.tasks = {}
        self.by_stage = {}
        self.ready = {}
        self._mapped = set()
        for st in self.spec.topological():
            sd = dict(ev.stages.get(st.name, {}))
            self.stages[st.name] = StageStatus(
                name=st.name, script=st.script,
                expected=int(sd.get("expected", 0)),
                submitted=int(sd.get("submitted", 0)),
                done=int(sd.get("done", 0)),
                failed=int(sd.get("failed", 0)),
                retried=int(sd.get("retried", 0)),
                errors=int(sd.get("errors", 0)),
                skipped=int(sd.get("skipped", 0)),
                revoked=int(sd.get("revoked", 0)),
                revoke_pending=int(sd.get("revoke_pending", 0)))
            self.by_stage[st.name] = []
            self.ready[st.name] = []
        for td in ev.tasks:  # per-stage creation order (see snapshot_event)
            rec = TaskRecord(
                task_id=td["task_id"], stage=td["stage"],
                index=int(td.get("index", 0)),
                params=dict(td.get("params", {})),
                dep_ids=tuple(td.get("dep_ids", ())),
                attempts=int(td.get("attempts", 0)),
                done=bool(td.get("done", False)),
                failed=bool(td.get("failed", False)),
                skipped=bool(td.get("skipped", False)),
                revokes=int(td.get("revokes", 0)),
                revoke_pending=bool(td.get("revoke_pending", False)),
                result=(dict(td["result"])
                        if td.get("result") is not None else None))
            self.tasks[rec.task_id] = rec
            self.by_stage[rec.stage].append(rec.task_id)
            for dep in rec.dep_ids:
                self._mapped.add((dep, rec.stage))
            if not rec.terminal and (rec.attempts == 0 or rec.revoke_pending):
                self.ready[rec.stage].append(rec.task_id)
        self.joins_fired = set(ev.joins_fired)
        self.preemptions = int(ev.preemptions)
        return True

    def _maybe_complete(self, ts: float) -> None:
        if self.done:
            return
        if all(self.stages[n].complete for n in self.stages):
            self.state = self.COMPLETED
            self.finished_at = ts

    # -- non-journaled observability --------------------------------------

    def count_duplicate(self, task_id: str) -> None:
        """A fenced duplicate/late result. Deliberately not an event: the
        counter restarts at zero after a replay."""
        rec = self.tasks.get(task_id)
        if rec is not None:
            self.stages[rec.stage].duplicates += 1

    # -- equality (replay-idempotence contract) ----------------------------

    def snapshot(self) -> dict:
        """Domain state only — ``seq`` and duplicate counters are
        bookkeeping, excluded so ``fold(ev) == fold(ev + dup_suffix)``."""
        stages = {}
        for n, s in self.stages.items():
            d = s.to_dict()
            d.pop("duplicates", None)
            stages[n] = d
        return {
            "campaign_id": self.campaign_id,
            "pipeline": self.pipeline,
            "state": self.state,
            "failure": self.failure,
            "weight": self.weight,
            "items": list(self.items),
            "params": dict(self.params),
            "stages": stages,
            "tasks": {t: r.to_dict() for t, r in sorted(self.tasks.items())},
            "by_stage": self.by_stage,
            "ready": self.ready,
            "joins_fired": sorted(self.joins_fired),
            "preemptions": self.preemptions,
        }

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, CampaignState):
            return NotImplemented
        return self.snapshot() == other.snapshot()

    __hash__ = None  # mutable


# --------------------------------------------------------------------------
# Decide functions (pure planners: state -> [events])
# --------------------------------------------------------------------------


def _task_id(campaign_id: str, stage: str, index: int) -> str:
    return f"{campaign_id}-{stage}-{index:05d}"


def plan_sources(state: CampaignState) -> list[JournalEvent]:
    """Source-stage tasks for the campaign's items (fan-out batching).
    Idempotent: already-planned task ids are skipped, so it doubles as the
    recovery repair pass for a journal truncated mid-seed."""
    evs: list[JournalEvent] = []
    for st in state.spec.sources():
        if st.fan_out is None:
            batches = [state.items]
        else:
            batches = [state.items[i:i + st.fan_out]
                       for i in range(0, len(state.items), st.fan_out)] \
                or [[]]
        for bi, batch in enumerate(batches):
            tid = _task_id(state.campaign_id, st.name, bi)
            if tid in state.tasks:
                continue
            evs.append(StageDispatched(
                campaign_id=state.campaign_id, stage=st.name, task_id=tid,
                index=bi, params={"batch": list(batch), "batch_index": bi}))
    return evs


def plan_downstream(state: CampaignState, task_id: str) -> list[JournalEvent]:
    """Events that follow one task reaching a terminal state (done or
    skipped): map tasks 1:1, skip cascades, and join barriers (exactly once,
    with the assembled upstream payload). Pure and guard-checked — planning
    the same task twice, or re-planning during recovery repair, yields no
    events. Callers apply each returned event before planning the next task
    (indexes are read from the folded state)."""
    rec = state.tasks[task_id]
    if not (rec.done or rec.skipped):
        return []
    cid = state.campaign_id
    evs: list[JournalEvent] = []
    for ds in state.spec.downstream(rec.stage):
        if not ds.join:
            if (task_id, ds.name) in state._mapped:
                continue  # already planned (replayed journal)
            idx = len(state.by_stage[ds.name])
            tid = _task_id(cid, ds.name, idx)
            if rec.skipped or (ds.skip_when is not None
                               and ds.skip_when(rec.result)):
                evs.append(StageSkipped(campaign_id=cid, stage=ds.name,
                                        task_id=tid, index=idx,
                                        dep_ids=(task_id,)))
            else:
                evs.append(StageDispatched(
                    campaign_id=cid, stage=ds.name, task_id=tid, index=idx,
                    params={"upstream": rec.result, "dep_index": rec.index},
                    dep_ids=(task_id,)))
        elif (ds.name not in state.joins_fired
              or not state.by_stage[ds.name]) and \
                all(state.stage_complete(d) for d in ds.depends_on):
            # second disjunct: torn write — BarrierReleased journaled but the
            # crash ate the join task's dispatch; re-plan the task without
            # re-firing the (idempotent) barrier
            if ds.name not in state.joins_fired:
                evs.append(BarrierReleased(campaign_id=cid, stage=ds.name))
            upstream: dict[str, list] = {}
            dep_ids: list[str] = []
            for dep in ds.depends_on:
                live = [t for t in state.by_stage[dep]
                        if not state.tasks[t].skipped]
                upstream[dep] = [state.tasks[t].result for t in live]
                dep_ids.extend(live)
            idx = len(state.by_stage[ds.name])
            tid = _task_id(cid, ds.name, idx)
            if ds.skip_when is not None and ds.skip_when(upstream):
                evs.append(StageSkipped(campaign_id=cid, stage=ds.name,
                                        task_id=tid, index=idx,
                                        dep_ids=tuple(dep_ids)))
            else:
                evs.append(StageDispatched(
                    campaign_id=cid, stage=ds.name, task_id=tid, index=idx,
                    params={"upstream": upstream}, dep_ids=tuple(dep_ids)))
    return evs


def group_journal(records: Iterable[Mapping[str, Any]]
                  ) -> dict[str, list[JournalEvent]]:
    """Split raw ``PREFIX-campaigns`` records into per-campaign event lists,
    sorted by ``seq`` with duplicates dropped (at-least-once journal reads
    and partially-flushed tails both produce repeats). Snapshot records are
    ignored."""
    by_campaign: dict[str, dict[int, JournalEvent]] = {}
    for value in records:
        if not is_journal_record(value):
            continue
        ev = event_from_dict(value)
        seqs = by_campaign.setdefault(ev.campaign_id, {})
        seqs.setdefault(ev.seq, ev)
    return {cid: [seqs[s] for s in sorted(seqs)]
            for cid, seqs in by_campaign.items()}
