"""Unified task-lease lifecycle — the one way work is taken back.

The control plane used to have four disjoint stop-work mechanisms: the
MonitorAgent watchdog resubmitted stale tasks, the autoscaler's graceful
drain requeued deferred leases, SimSlurm's ``scancel``/walltime fired a
``cancel_event``, and the PipelineAgent fenced late results of retried
tasks — each with its own bookkeeping and its own races. The paper's own
ClusterAgent already treats reclamation as a first-class operation ("if a
task hangs or exceeds the predefined timeout, the ClusterAgent intervenes
by canceling the associated Slurm job", §3), and both ParaFold
(arXiv:2111.06340) and the Summit proteome-scale deployment
(arXiv:2201.10024) show heterogeneous campaigns stay fast only when the
scheduler can actively take resources *back*, not just hand them out.

This module is that primitive. A :class:`Lease` is the broker-tracked
handle for one attempt of one task on one holder, with a single state
machine::

    GRANTED ──→ RUNNING ──→ DONE
       │           │    └──→ FAILED
       └───────────┴───────→ REVOKED(reason)

* **GRANTED** — the holder committed the record's offset via
  :meth:`~repro_torch.core.broker.Broker.lease_records` (the task is its
  responsibility; it may still be waiting in a deferral queue),
* **RUNNING** — execution started (:meth:`~repro_torch.core.broker.Broker.claim_start`
  bound the task's ``cancel_event`` so a revocation can actually stop it),
* **DONE** / **FAILED** — the holder committed its verdict through the
  :meth:`~repro_torch.core.broker.Broker.complete_lease` gate,
* **REVOKED** — :meth:`~repro_torch.core.broker.Broker.revoke_lease` took the
  lease back: the ``cancel_event`` fires (``check_cancel`` raises inside
  the computation), any late ``complete_lease`` from the old holder
  returns False (the commit is *fenced* — no stale result or error ever
  leaves the agent), and, when requested, the task record is requeued
  onto the topic it was leased from — all in one critical section under
  the broker lock, so a revoked task is never both requeued and completed.

Every stopper is now a caller: the agent/monitor watchdogs revoke with
``reason="watchdog"``, graceful drain flushes deferred leases with
``reason="drain"``, SimSlurm walltime/scancel policing uses
``reason="scancel"``, memory policing uses ``reason="mem_overage"``, and
the PipelineAgent's preemptive fair share revokes with
``reason="preempt"`` (journaled as a ``LeaseRevoked`` event so recovery
replays revocations exactly like completions).
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Sequence

# -- lease states ------------------------------------------------------------

GRANTED = "GRANTED"
RUNNING = "RUNNING"
DONE = "DONE"
FAILED = "FAILED"
REVOKED = "REVOKED"

LIVE_STATES = (GRANTED, RUNNING)


class RevokeReason:
    """Why a lease was taken back (the ``REVOKED(reason=...)`` tag)."""

    WATCHDOG = "watchdog"        # hung / timed-out / stale-heartbeat task
    PREEMPT = "preempt"          # fair-share preemption of an over-share campaign
    MEM_OVERAGE = "mem_overage"  # task exceeded its Resources.mem_mb request
    DRAIN = "drain"              # agent leaving (autoscale shrink / stop)
    SCANCEL = "scancel"          # slurm-side stop (walltime / external scancel)

    ALL = (WATCHDOG, PREEMPT, MEM_OVERAGE, DRAIN, SCANCEL)


# how long an unacknowledged REVOKED entry is kept for commit fencing before
# the periodic sweep drops it (holders that crashed never ack)
_REVOKED_TTL_S = 120.0

# completion tombstones retained for duplicate-execution fencing (a stale
# requeued/resubmitted record of an already-accepted task must never run)
_DONE_CAP = 4096


@dataclass(frozen=True)
class LeaseTolerance:
    """WAN-tolerance policy for leases held across a slow link.

    A federated site's bridge holds home-broker leases for tasks executing
    remotely; its heartbeats cross a WAN link whose round-trip can dwarf the
    uniform watchdog deadline tuned for local workers. Instead of loosening
    every deadline to the slowest link (masking genuinely hung local tasks),
    holders registered with a tolerance get a *per-site* heartbeat deadline
    stamped onto each lease they are granted::

        deadline_s = base_timeout_s * rtt_factor + slack_s

    where ``base_timeout_s`` is the watchdog's configured deadline. The
    MonitorAgent and PipelineAgent watchdogs consult the stamped deadline
    before revoking, so a healthy remote lease behind a slow-but-alive link
    survives, while cross-site revocation still fences exactly-once
    execution when the lease really is taken back."""

    slack_s: float = 0.0     # absolute extra headroom (e.g. 2 * link RTT)
    rtt_factor: float = 1.0  # multiplier on the watchdog's base deadline

    def deadline(self, base_timeout_s: float | None) -> float | None:
        """Per-site heartbeat deadline for a given base watchdog timeout.
        None base (watchdog disabled) stays None unless slack alone is
        meaningful — a pure-slack tolerance still bounds the lease."""
        if base_timeout_s is None:
            return self.slack_s if self.slack_s > 0 else None
        return base_timeout_s * self.rtt_factor + self.slack_s


@dataclass(slots=True)
class Lease:
    """One attempt of one task held by one agent (broker-internal record).

    ``value`` keeps the leased record's payload so a revocation can requeue
    the task without a topic scan; ``seq`` is the broker-wide monotonic
    grant sequence (journaled observability, not a fencing token — fencing
    is by ``(holder, attempt)``)."""

    task_id: str
    holder: str
    topic: str
    attempt: int
    value: dict
    seq: int
    granted_at: float = field(default_factory=time.time)
    state: str = GRANTED
    started_at: float | None = None
    revoked_at: float | None = None
    reason: str | None = None
    cancel: threading.Event | None = None
    on_revoke: Callable[[], None] | None = None
    site: str = ""                   # holder's site ("" = broker-local)
    deadline_s: float | None = None  # per-site heartbeat deadline, if any

    @property
    def live(self) -> bool:
        return self.state in LIVE_STATES

    def view(self) -> dict:
        """JSON-safe snapshot for observability / victim selection."""
        return {
            "task_id": self.task_id,
            "holder": self.holder,
            "topic": self.topic,
            "attempt": self.attempt,
            "seq": self.seq,
            "state": self.state,
            "granted_at": self.granted_at,
            "started_at": self.started_at,
            "revoked_at": self.revoked_at,
            "reason": self.reason,
            "campaign_id": self.value.get("campaign_id"),
            "site": self.site,
            "deadline_s": self.deadline_s,
        }


class LeaseTable:
    """One shard of the broker's lease registry. **Not** thread-safe on its
    own — every method is called with the owning lock held (the broker's
    single lock in ``single_lock`` mode, the shard lock of a
    :class:`ShardedLeaseTable` otherwise), which is what makes
    revoke-vs-complete atomic per task.

    ``seq_source`` injects a shared grant-sequence counter so N shards keep
    one broker-wide monotonic ``Lease.seq``; ``done_cap`` bounds this
    shard's completion-tombstone dict (a sharded table divides the global
    cap across shards)."""

    def __init__(self, metrics=None, *,
                 seq_source: Iterator[int] | None = None,
                 done_cap: int = _DONE_CAP) -> None:
        # counters live in the obs registry (repro_torch.obs) so /metrics and the
        # legacy stats() dict are the same numbers; a standalone table (unit
        # tests, direct wiring) gets a private registry. Registration is
        # idempotent by name, so every shard of a ShardedLeaseTable shares
        # the same counter families.
        from repro_torch.obs import MetricsRegistry
        reg = metrics if metrics is not None else MetricsRegistry()
        self._c_granted = reg.counter(
            "ksa_leases_granted_total", "Leases granted (GRANTED entered)")
        self._c_completed = reg.counter(
            "ksa_leases_completed_total", "Leases committed DONE")
        self._c_failed = reg.counter(
            "ksa_leases_failed_total", "Leases committed FAILED")
        self._c_requeued = reg.counter(
            "ksa_leases_requeued_total",
            "Revoked lease records requeued by the broker")
        self._c_stale = reg.counter(
            "ksa_lease_stale_drops_total",
            "Stale sibling records refused (grant or claim)")
        self._c_revoked = reg.counter(
            "ksa_leases_revoked_total", "Leases revoked, by reason",
            labels=("reason",))
        for r in RevokeReason.ALL:  # pre-create so stats() always lists ALL
            self._c_revoked.labels(reason=r)
        self._leases: dict[str, Lease] = {}
        # task_id -> accepted attempt: completion tombstones. Stop-path
        # requeues and watchdog resubmissions race the attempt they
        # replace; when the older attempt wins, its sibling record is
        # still on a topic and will be leased later — the tombstone makes
        # claim_start refuse it, so a finished task is never re-executed
        # (exactly-once *execution*, not just exactly-once result).
        # A deliberate rerun of a finished task id needs a higher attempt.
        self._done: dict[str, int] = {}
        self._done_cap = done_cap
        self._next_seq = seq_source if seq_source is not None \
            else itertools.count(1)

    # -- counter views (registry-backed; the attribute names predate obs) --

    @property
    def granted(self) -> int:
        return self._c_granted.value

    @property
    def completed(self) -> int:
        return self._c_completed.value

    @property
    def failed(self) -> int:
        return self._c_failed.value

    @property
    def requeued(self) -> int:
        return self._c_requeued.value

    @property
    def stale_drops(self) -> int:
        return self._c_stale.value

    @property
    def revoked(self) -> dict:
        return {key[0]: child.value for key, child in self._c_revoked.items()}

    def count_requeued(self) -> None:
        """Called by the broker when it requeues a revoked lease's record."""
        self._c_requeued.inc()

    # -- lifecycle ---------------------------------------------------------

    def grant(self, task_id: str, holder: str, topic: str, attempt: int,
              value: dict, *, site: str = "",
              deadline_s: float | None = None,
              now: float | None = None) -> Lease | None:
        """Register a fresh GRANTED lease (replaces any stale entry for the
        task — a requeued task's new lease supersedes the fenced old one).
        A record whose attempt is *behind* a live lease is the stale
        sibling of a requeue race: it must not clobber the newer lease
        (its claim will be refused instead). ``site``/``deadline_s`` stamp
        the holder's federation site and WAN-tolerant heartbeat deadline
        (see :class:`LeaseTolerance`) onto the lease for the watchdogs.
        ``now`` lets a batched grant path stamp one shared timestamp."""
        cur = self._leases.get(task_id)
        if cur is not None and cur.live and cur.attempt > attempt:
            self._c_stale.inc()
            return None
        lease = Lease(task_id=task_id, holder=holder, topic=topic,
                      attempt=attempt, value=value, seq=next(self._next_seq),
                      site=site, deadline_s=deadline_s)
        if now is not None:
            lease.granted_at = now
        self._leases[task_id] = lease
        self._c_granted.inc()
        return lease

    def grant_batch(self, records: Sequence, holder: str, *, site: str = "",
                    deadline_s: float | None = None,
                    now: float | None = None) -> list:
        """Grant leases for a batch of fetched records in one pass under the
        caller's (shard) lock — one timestamp, one counter bump per grant,
        no per-record lock round-trips. ``records`` are broker ``Record``s
        whose ``value`` carries ``task_id``/``attempt``; non-task records
        pass through with a ``None`` lease. Returns ``[(record, lease|None),
        ...]`` in input order."""
        stamp = time.time() if now is None else now
        out = []
        leases, n_stale = self._leases, 0
        seq = self._next_seq
        for rec in records:
            # inlined grant() with counters tallied once per batch instead
            # of one locked inc per record
            task_id = rec.key
            value = rec.value
            attempt = int(value.get("attempt", 0))
            cur = leases.get(task_id)
            if cur is not None and cur.live and cur.attempt > attempt:
                n_stale += 1
                out.append((rec, None))
                continue
            # positional construction: kwarg binding is measurable at
            # 100k+ grants/s on the sharded hot path
            lease = Lease(task_id, holder, rec.topic, attempt, value,
                          next(seq), stamp, GRANTED, None, None, None,
                          None, None, site, deadline_s)
            leases[task_id] = lease
            out.append((rec, lease))
        n_granted = len(out) - n_stale
        if n_granted:
            self._c_granted.inc(n_granted)
        if n_stale:
            self._c_stale.inc(n_stale)
        return out

    def claim_start(self, task_id: str, holder: str, attempt: int,
                    cancel: threading.Event,
                    on_revoke: Callable[[], None] | None = None) -> bool:
        """GRANTED → RUNNING iff ``(holder, attempt)`` still owns an
        unrevoked lease; binds the cancel event so a later revocation can
        stop the execution. Returns False (and acks/drops a revoked or
        superseded entry) when the holder must *not* start the task."""
        if task_id in self._done:
            # the task already completed (possibly on a sibling attempt
            # that won a requeue/resubmission race): no attempt of a
            # completed task ever executes again — every resubmitter
            # (monitor, pipeline, recovery) checks terminality first, so a
            # late record here is always a stale race artifact
            lease = self._leases.get(task_id)
            if lease is not None and lease.holder == holder \
                    and lease.attempt == attempt:
                del self._leases[task_id]
            self._c_stale.inc()
            return False
        lease = self._leases.get(task_id)
        if lease is None:
            return True  # unregistered execution (direct wiring): no fencing
        if lease.holder != holder or lease.attempt != attempt:
            return False  # superseded: another holder owns the task now
        if lease.state == REVOKED:
            del self._leases[task_id]  # ack: the revocation already requeued
            return False
        if lease.state != GRANTED:
            # already RUNNING: a same-attempt duplicate record (e.g. the
            # requeued copy of a deferred lease the same agent re-leased)
            # must not start a second concurrent execution
            return False
        lease.state = RUNNING
        lease.started_at = time.time()
        lease.cancel = cancel
        lease.on_revoke = on_revoke
        return True

    def complete(self, task_id: str, holder: str | None, attempt: int | None,
                 ok: bool) -> bool:
        """The commit gate: True iff the holder may publish its verdict
        (result or error). A revoked or superseded lease returns False —
        the work was already requeued, so the stale outcome must not leave
        the agent. Terminal either way: the entry is dropped."""
        lease = self._leases.get(task_id)
        if lease is None:
            # no lease tracked: either direct wiring (no fencing) or a
            # stale sibling whose task already completed — the tombstone
            # tells the two apart
            return task_id not in self._done
        if holder is not None and lease.holder != holder:
            return False  # superseded: not this holder's lease any more
        if attempt is not None and lease.attempt != attempt:
            return False
        del self._leases[task_id]
        if lease.state == REVOKED:
            return False
        lease.state = DONE if ok else FAILED
        if ok:
            self._c_completed.inc()
            self._done[task_id] = lease.attempt
            if len(self._done) > self._done_cap:
                self._done.pop(next(iter(self._done)))
        else:
            self._c_failed.inc()
        return True

    def complete_batch(self, items: Sequence, holder: str | None,
                       ok: bool) -> list:
        """Batched :meth:`complete` under the caller's (shard) lock:
        ``items`` is ``[(task_id, attempt|None), ...]`` sharing one wave
        outcome ``ok`` (a holder commits successes and failures as separate
        waves); every entry passes through the same commit gate, with the
        completed/failed counters bumped once per batch instead of once per
        record. Returns ``[(task_id, committed, lease|None), ...]`` in
        input order."""
        out: list = []
        n_terminal = 0
        state = DONE if ok else FAILED
        leases, done = self._leases, self._done
        for task_id, attempt in items:
            lease = leases.get(task_id)
            if lease is None:
                out.append((task_id, task_id not in done, None))
                continue
            if (holder is not None and lease.holder != holder) \
                    or (attempt is not None and lease.attempt != attempt):
                out.append((task_id, False, lease))
                continue
            del leases[task_id]
            if lease.state == REVOKED:
                out.append((task_id, False, lease))
                continue
            lease.state = state
            n_terminal += 1
            if ok:
                done[task_id] = lease.attempt
            out.append((task_id, True, lease))
        while len(done) > self._done_cap:
            done.pop(next(iter(done)))
        if n_terminal:
            (self._c_completed if ok else self._c_failed).inc(n_terminal)
        return out

    def revoke(self, task_id: str, reason: str) -> Lease | None:
        """Take a live lease back: fire the cancel event (and the holder's
        ``on_revoke`` hook, e.g. ``scancel``), tag the reason, and return
        the lease so the broker can requeue its record in the same critical
        section. None if there is nothing live to revoke (already terminal,
        unknown, or mid-completion — the race the gate exists for)."""
        lease = self._leases.get(task_id)
        if lease is None or not lease.live:
            return None
        lease.state = REVOKED
        lease.reason = reason
        lease.revoked_at = time.time()
        self._c_revoked.labels(reason=reason).inc()
        if lease.cancel is not None:
            lease.cancel.set()
        if lease.on_revoke is not None:
            try:
                lease.on_revoke()
            except Exception:  # pragma: no cover - defensive
                pass
        self._sweep(lease.revoked_at)
        return lease

    def forget(self, task_id: str, holder: str) -> None:
        """Drop a lease the holder gave up without executing (reroute of a
        misplaced task — the rerouted record grants a fresh lease)."""
        lease = self._leases.get(task_id)
        if lease is not None and lease.holder == holder:
            del self._leases[task_id]

    def _sweep(self, now: float) -> None:
        """GC revoked entries whose (dead) holder will never ack."""
        stale = [t for t, l in self._leases.items()
                 if l.state == REVOKED and l.revoked_at is not None
                 and now - l.revoked_at > _REVOKED_TTL_S]
        for t in stale:
            del self._leases[t]

    # -- queries -----------------------------------------------------------

    def get(self, task_id: str) -> Lease | None:
        return self._leases.get(task_id)

    def live_views(self, task_ids=None, holder: str | None = None) -> list[dict]:
        out = []
        leases = ([self._leases.get(t) for t in task_ids]
                  if task_ids is not None else list(self._leases.values()))
        for lease in leases:
            if lease is None or not lease.live:
                continue
            if holder is not None and lease.holder != holder:
                continue
            out.append(lease.view())
        return out

    def stats(self) -> dict:
        return {
            "active": sum(1 for l in self._leases.values() if l.live),
            "granted": self.granted,
            "completed": self.completed,
            "failed": self.failed,
            "requeued": self.requeued,
            "stale_drops": self.stale_drops,
            "revoked": dict(self.revoked),
            "revoked_total": sum(self.revoked.values()),
        }


class ShardedLeaseTable:
    """Task-id-hash-sharded lease registry — grant/claim/complete/revoke on
    tasks in different shards never contend.

    Each shard is a plain :class:`LeaseTable` guarded by its own lock; a
    task's shard is a pure function of its id, so every lifecycle operation
    for one task serializes on the same lock and the per-task atomicity
    contracts are exactly those of the single-table broker. Unlike
    :class:`LeaseTable`, locking is owned *here*: callers never wrap calls
    in their own lock. The broker injects ``lock_factory`` so its
    ``single_lock`` (all shards alias the master lock) and ``debug_locks``
    (order-checked locks) modes compose; shard locks rank between the group
    lock and the partition locks in the broker's lock hierarchy — see the
    :mod:`repro_torch.core.broker` docstring.

    Cross-shard invariants are preserved by construction: the grant
    sequence is one shared ``itertools.count`` (broker-wide monotonic
    ``Lease.seq``), the counters are one shared registry family (counter
    registration is idempotent by name), and the completion-tombstone cap
    is divided across shards."""

    def __init__(self, metrics=None, *, shards: int = 8,
                 lock_factory: Callable[[int], Any] | None = None) -> None:
        n = max(1, int(shards))
        seq = itertools.count(1)
        cap = max(256, _DONE_CAP // n)
        self._tables = [LeaseTable(metrics, seq_source=seq, done_cap=cap)
                        for _ in range(n)]
        make = lock_factory if lock_factory is not None \
            else (lambda i: threading.RLock())
        self._locks = [make(i) for i in range(n)]
        self._n = n

    @property
    def shards(self) -> int:
        return self._n

    def shard_of(self, task_id: str) -> int:
        return hash(task_id) % self._n

    # -- lifecycle ---------------------------------------------------------

    def grant(self, task_id: str, holder: str, topic: str, attempt: int,
              value: dict, *, site: str = "",
              deadline_s: float | None = None,
              now: float | None = None) -> Lease | None:
        """Per-record grant (the legacy data plane uses this; the sharded
        hot path batches through :meth:`grant_batch`)."""
        i = self.shard_of(task_id)
        with self._locks[i]:
            return self._tables[i].grant(
                task_id, holder, topic, attempt, value,
                site=site, deadline_s=deadline_s, now=now)

    def grant_batch(self, records: Sequence, holder: str, *, site: str = "",
                    deadline_s: float | None = None,
                    now: float | None = None) -> list:
        """Grant leases for a batch of task records with one critical
        section per shard touched (not per record). Returns
        ``[(record, lease|None), ...]``; order is per-shard, which is fine
        for the observability fan-out this feeds."""
        stamp = time.time() if now is None else now
        if self._n == 1:
            with self._locks[0]:
                return self._tables[0].grant_batch(
                    records, holder, site=site, deadline_s=deadline_s,
                    now=stamp)
        n = self._n
        buckets: dict[int, list] = {}
        for rec in records:
            buckets.setdefault(hash(rec.key) % n, []).append(rec)
        out: list = []
        for i in sorted(buckets):  # one shard lock at a time, ascending
            with self._locks[i]:
                out.extend(self._tables[i].grant_batch(
                    buckets[i], holder, site=site, deadline_s=deadline_s,
                    now=stamp))
        return out

    def claim_start(self, task_id: str, holder: str, attempt: int,
                    cancel: threading.Event,
                    on_revoke: Callable[[], None] | None = None
                    ) -> tuple[bool, Lease | None]:
        """GRANTED → RUNNING under the task's shard lock. Returns
        ``(ok, lease)`` — the lease (claimed in place when ok) lets the
        broker observe grant→claim latency *outside* the lock."""
        i = self.shard_of(task_id)
        with self._locks[i]:
            t = self._tables[i]
            lease = t.get(task_id)
            ok = t.claim_start(task_id, holder, attempt, cancel, on_revoke)
            return ok, lease

    def claim_start_batch(self, items: Sequence, holder: str,
                          cancel: threading.Event,
                          on_revoke: Callable[[], None] | None = None
                          ) -> list:
        """Batched :meth:`claim_start`: ``items`` is ``[(task_id, attempt),
        ...]``; all claims landing on the same shard share one critical
        section (shards visited in ascending order). Every claim in the
        batch binds the same ``cancel``/``on_revoke`` — the caller is one
        holder starting one wave of tasks. Returns ``[(task_id, ok, lease),
        ...]`` grouped by shard."""
        n = self._n
        buckets: dict[int, list] = {}
        for item in items:
            buckets.setdefault(hash(item[0]) % n, []).append(item)
        out: list = []
        now = time.time()
        for i in sorted(buckets):
            with self._locks[i]:
                t = self._tables[i]
                leases, done = t._leases, t._done
                for task_id, attempt in buckets[i]:
                    lease = leases.get(task_id)
                    # fast path: the normal GRANTED -> RUNNING transition,
                    # with one shared timestamp for the whole wave
                    if lease is not None and lease.state == GRANTED \
                            and lease.holder == holder \
                            and lease.attempt == attempt \
                            and task_id not in done:
                        lease.state = RUNNING
                        lease.started_at = now
                        lease.cancel = cancel
                        lease.on_revoke = on_revoke
                        out.append((task_id, True, lease))
                        continue
                    # anything unusual (tombstone, fencing, revoked-ack,
                    # duplicate) takes the scalar gate
                    ok = t.claim_start(task_id, holder, attempt, cancel,
                                       on_revoke)
                    out.append((task_id, ok, lease))
        return out

    def complete(self, task_id: str, holder: str | None, attempt: int | None,
                 ok: bool) -> tuple[bool, Lease | None]:
        """The commit gate, under the task's shard lock. Returns
        ``(committed, lease)`` for out-of-lock observability."""
        i = self.shard_of(task_id)
        with self._locks[i]:
            t = self._tables[i]
            lease = t.get(task_id)
            committed = t.complete(task_id, holder, attempt, ok)
            return committed, lease

    def complete_batch(self, items: Sequence, holder: str | None,
                       ok: bool) -> list:
        """Batched :meth:`complete`: ``items`` is ``[(task_id,
        attempt|None), ...]`` sharing one wave outcome ``ok``; one critical
        section per shard touched. Each entry goes through the same commit
        gate (fencing, tombstones) as the scalar path. Returns
        ``[(task_id, committed, lease), ...]`` grouped by shard."""
        n = self._n
        buckets: dict[int, list] = {}
        for item in items:
            buckets.setdefault(hash(item[0]) % n, []).append(item)
        out: list = []
        for i in sorted(buckets):
            with self._locks[i]:
                out.extend(self._tables[i].complete_batch(buckets[i],
                                                          holder, ok))
        return out

    def revoke(self, task_id: str, reason: str,
               requeue_cb: Callable[[Lease], None] | None = None
               ) -> Lease | None:
        """Fence + cancel + (optionally) requeue in ONE critical section
        under the task's shard lock: ``requeue_cb(lease)`` runs while the
        shard lock is held, so a revoked task is never both requeued and
        completed — the same atomicity the single broker lock provided.
        The callback may produce (shard lock → partition lock is the legal
        lock order) but must not touch group state."""
        i = self.shard_of(task_id)
        with self._locks[i]:
            t = self._tables[i]
            lease = t.revoke(task_id, reason)
            if lease is not None and requeue_cb is not None:
                t.count_requeued()
                requeue_cb(lease)
            return lease

    def forget(self, task_id: str, holder: str) -> None:
        i = self.shard_of(task_id)
        with self._locks[i]:
            self._tables[i].forget(task_id, holder)

    # -- queries -----------------------------------------------------------

    def get_view(self, task_id: str) -> dict | None:
        i = self.shard_of(task_id)
        with self._locks[i]:
            lease = self._tables[i].get(task_id)
            return None if lease is None else lease.view()

    def live_views(self, task_ids=None, holder: str | None = None) -> list[dict]:
        if task_ids is not None:
            out: list[dict] = []
            for tid in task_ids:
                i = self.shard_of(tid)
                with self._locks[i]:
                    out.extend(self._tables[i].live_views([tid], holder))
            return out
        out = []
        for lock, t in zip(self._locks, self._tables):
            with lock:  # one shard at a time — never two shard locks held
                out.extend(t.live_views(None, holder))
        return out

    def stats(self) -> dict:
        t0 = self._tables[0]  # counter families are shared across shards
        out = {
            "active": 0,
            "granted": t0.granted,
            "completed": t0.completed,
            "failed": t0.failed,
            "requeued": t0.requeued,
            "stale_drops": t0.stale_drops,
            "revoked": dict(t0.revoked),
            "revoked_total": sum(t0.revoked.values()),
        }
        for lock, t in zip(self._locks, self._tables):
            with lock:
                out["active"] += sum(1 for l in t._leases.values() if l.live)
        return out
