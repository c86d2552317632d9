"""ClusterAgent and WorkerAgent — the compute-side components of KSA (§3).

Both subscribe to the per-resource-class task topics their
:class:`~repro_torch.core.scheduling.ResourceProfile` can serve (``PREFIX-new.cpu``,
``PREFIX-new.gpu``, ...) in one shared consumer group — the broker
load-balances each class across the agents equipped for it, so a GPU stage
can never land on a CPU-only pool (resource-aware routing; an agent with no
declared profile subscribes to every class, the paper's original
any-agent-any-task behaviour). They differ only in *where* they run the work:

* :class:`WorkerAgent` — "executes the retrieved tasks directly on the
  workstation where it is running, using separate threads for each task."
* :class:`ClusterAgent` — submits tasks as Slurm jobs and manages their
  execution, including the paper's queue-filling strategy: "always submit more
  tasks to Slurm than can be immediately started … This approach ensures that
  the Slurm queue always has tasks waiting, allowing Slurm to start subsequent
  tasks as soon as resources become available", and the watchdog: "If a task
  hangs or exceeds the predefined timeout, the ClusterAgent intervenes by
  canceling the associated Slurm job."

Fault-tolerance contract (two levels, matching the paper):

1. *lease-commit*: an agent commits its consumer offset when it has accepted
   (leased) a task. If the agent dies **before** accepting, the group
   rebalance hands the partition — and the unread task — to a surviving agent.
2. *watchdog redelivery*: if the agent dies (or the task hangs) **after**
   accepting, the MonitorAgent notices the missing heartbeat/timeout and
   resubmits the task with a bumped attempt (at-least-once end-to-end;
   the monitor fences duplicate results by attempt).

Planned removal is a third, loss-free path: :meth:`AgentBase.request_drain`
(the autoscaler's scale-down mechanism) leaves the consumer group so unread
partitions rebalance to survivors, requeues deferred leases back onto their
class topics, lets in-flight tasks finish (heartbeating throughout, so the
monitor never mistakes a draining agent for a dead one), and only then
stops — no task is lost and none is double-run.

Every stop-path above routes through the unified lease layer
(:mod:`repro_torch.core.lease`): an accepted task holds a broker-tracked
:class:`~repro_torch.core.lease.Lease` whose execution is started through
:meth:`~repro_torch.core.broker.Broker.claim_start` (binding the cancel event),
committed through the :meth:`~repro_torch.core.broker.Broker.complete_lease`
fence, and taken back through :meth:`~repro_torch.core.broker.Broker.revoke_lease`
— the agent watchdog (``reason="watchdog"``), drain requeues
(``reason="drain"``), SimSlurm walltime/scancel policing
(``reason="scancel"``), and memory-overage policing
(``reason="mem_overage"``) are all callers of that one primitive, so a
revoked task is cancelled, its stale verdict fenced, and its record
requeued in one atomic broker operation.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from .broker import Broker, Consumer, Producer
from .computing import ClusterComputing, resolve_script
from .lease import RevokeReason
from .messages import (ErrorMessage, StatusUpdate, TaskMessage, TaskStatus,
                       topic_names)
from .scheduling import PlacementPolicy, ResourceClassPolicy, ResourceProfile
from .simslurm import SimSlurm

log = logging.getLogger(__name__)


class _AnyEvent:
    """Event-like view that is set when ANY of the underlying events is.

    Replaces the 10 ms ``_pump`` polling thread the ClusterAgent used to spin
    per Slurm job to merge its own cancel with scancel/walltime:
    ``is_set()`` composes the sources exactly and allocates no thread.
    ``set()`` fires the primary (agent-side) event.
    """

    def __init__(self, *events: threading.Event):
        self._events = tuple(events)

    def is_set(self) -> bool:
        return any(e.is_set() for e in self._events)

    def set(self) -> None:
        self._events[0].set()

    def wait(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self.is_set():
                return True
            chunk = 0.05
            if deadline is not None:
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                chunk = min(chunk, remaining)
            self._events[0].wait(chunk)


@dataclass
class _Running:
    task: TaskMessage
    cancel: threading.Event
    thread: threading.Thread | None = None
    slurm_job_id: int | None = None
    started_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.time)
    computing: Any = None            # live ClusterComputing (mem sampling)
    mem_tolerated: bool = False      # over-budget but past the revoke limit


class AgentBase:
    """Shared polling/lease/watchdog loop."""

    kind = "agent"

    def __init__(self, broker: Broker, prefix: str = "ksa", *,
                 agent_id: str | None = None,
                 slots: int = 4,
                 oversubscribe: int = 0,
                 profile: ResourceProfile | None = None,
                 placement: PlacementPolicy | None = None,
                 poll_interval_s: float = 0.05,
                 heartbeat_interval_s: float = 0.5,
                 default_timeout_s: float | None = None,
                 max_revoke_requeues: int = 3):
        self.broker = broker
        self.prefix = prefix
        self.topics = topic_names(prefix)
        self.agent_id = agent_id or f"{self.kind}-{id(self) & 0xffff:04x}"
        self.slots = slots
        # paper's ClusterAgent strategy: keep `oversubscribe` extra tasks
        # queued beyond what can start immediately.
        self.oversubscribe = oversubscribe
        # placement: profile=None -> subscribe every class (universal agent);
        # an explicit profile narrows the subscription to the classes the
        # pool can actually serve (resource-aware routing).
        self.profile = profile
        self.placement = placement or ResourceClassPolicy()
        self.poll_interval_s = poll_interval_s
        self.heartbeat_interval_s = heartbeat_interval_s
        # saturated-poll group-heartbeat cadence: the configured interval,
        # but bounded well under the broker's session timeout — a busy
        # agent that only heartbeats at the nominal interval can slip past
        # expiry under scheduler load and get falsely evicted (its live
        # lease revoked + requeued out from under it)
        self._group_hb_interval_s = min(
            heartbeat_interval_s, broker.session_timeout_s / 4.0)
        self._last_group_heartbeat = 0.0
        self.default_timeout_s = default_timeout_s
        self._producer = Producer(broker)
        self._subscriptions = tuple(
            self.placement.subscriptions(prefix, self.profile))
        self._consumer = Consumer(broker, list(self._subscriptions),
                                  group_id=f"{prefix}-agents",
                                  member_id=f"{prefix}-agents-{self.agent_id}")
        self._running: dict[str, _Running] = {}
        # leased tasks waiting for admission (mem-aware lease gate): the
        # offset is committed — the task is ours — but execution starts only
        # once it fits the profile's mem budget (the WorkerAgent analogue of
        # a SimSlurm PD job waiting for a node with free memory).
        self._deferred: deque[TaskMessage] = deque()
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._crashed = threading.Event()  # test hook: simulate sudden death
        # graceful-drain lifecycle (autoscale scale-down path): stop leasing,
        # requeue deferred leases, let in-flight work finish, deregister.
        self._draining = threading.Event()
        self._drain_deadline: float | None = None
        self._drain_entered = False
        # revocation-requeue bound: past this many attempts, mem-overage
        # policing tolerates the task instead of revoke-looping it forever
        # (the same spirit as the oversized-task admission escape hatch).
        self.max_revoke_requeues = max_revoke_requeues
        # lifecycle counters live in the broker's obs registry as one
        # labeled family; the legacy ``tasks_*`` attributes below are
        # read-only views over the same children (see properties)
        events = broker.metrics.counter(
            "ksa_agent_events_total",
            "Per-agent task lifecycle events", labels=("agent", "event"))
        self._c = {e: events.labels(agent=self.agent_id, event=e)
                   for e in ("completed", "failed", "rerouted", "deferred",
                             "requeued", "revoked", "dropped_revoked",
                             "mem_revoked", "heartbeat_failures")}

    # -- counter views (registry-backed; names predate repro_torch.obs) ----------

    @property
    def tasks_completed(self) -> int:
        return self._c["completed"].value

    @property
    def tasks_failed(self) -> int:
        return self._c["failed"].value

    @property
    def tasks_rerouted(self) -> int:
        return self._c["rerouted"].value

    @property
    def tasks_deferred(self) -> int:
        return self._c["deferred"].value

    @property
    def tasks_requeued(self) -> int:
        return self._c["requeued"].value

    @property
    def tasks_revoked(self) -> int:
        return self._c["revoked"].value

    @property
    def tasks_dropped_revoked(self) -> int:
        return self._c["dropped_revoked"].value

    @property
    def mem_revoked(self) -> int:
        return self._c["mem_revoked"].value

    @property
    def heartbeat_failures(self) -> int:
        return self._c["heartbeat_failures"].value

    # -- capacity -------------------------------------------------------------

    def _in_flight(self) -> int:
        with self._lock:
            return len(self._running)

    def _capacity(self) -> int:
        """How many more tasks to lease right now (deferred leases count —
        they already occupy a slot's worth of committed work)."""
        return (self.slots + self.oversubscribe) \
            - self._in_flight() - len(self._deferred)

    def _admit(self, task: TaskMessage) -> bool:
        """Lease-time admission gate; subclasses veto starting a task *now*
        (it stays leased in the deferral queue). Base: always admit."""
        return True

    def _admit_deferred(self) -> None:
        while self._deferred and self._admit(self._deferred[0]):
            self._accept(self._deferred.popleft())

    # -- main loop ----------------------------------------------------------------

    def start(self) -> "AgentBase":
        self._thread = threading.Thread(target=self._loop,
                                        name=f"{self.agent_id}-loop",
                                        daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set() and not self._crashed.is_set():
            try:
                if self._draining.is_set():
                    if self._drain_tick():
                        break
                else:
                    self._tick()
            except Exception:  # pragma: no cover - defensive
                log.exception("agent %s tick failed", self.agent_id)
            self._stop.wait(self.poll_interval_s)
        # crashed agents do NOT leave the group: the broker's session timeout
        # must evict them (that is the failure mode being simulated).
        if self._crashed.is_set():
            return
        # cancel whatever is still running so it gets redelivered — a no-op
        # after a completed graceful drain, and the stop() contract when
        # stop() overrides a drain still in progress
        self._drain()
        # either path: leased-but-unstarted tasks must survive the agent —
        # an offset this agent committed is a task nobody else will be given
        self._flush_deferred()
        self._consumer.close()

    def _tick(self) -> None:
        self._admit_deferred()
        cap = self._capacity()
        if cap > 0:
            # lease-commit (see module docstring) — fetch and commit are
            # one atomic broker operation, so a rebalance caused by a pool
            # scaling up mid-tick can never redeliver (and double-run) a
            # task this agent already leased
            for rec in self._consumer.lease(timeout=0.0, max_records=cap):
                task = TaskMessage.from_dict(rec.value)
                if not self._routable(task):
                    continue
                # FIFO behind an existing deferral: admitting fresh
                # leases past the queue head would starve a big task
                # under a stream of small ones
                if not self._deferred and self._admit(task):
                    self._accept(task)
                else:
                    self._deferred.append(task)
                    self._c["deferred"].inc()
        else:
            # still heartbeat group membership while saturated — but at the
            # (session-timeout-bounded) heartbeat interval, not per poll
            # tick: a 5ms tick hammering the group lock adds contention
            # for no extra liveness
            now = time.time()
            if now - self._last_group_heartbeat >= self._group_hb_interval_s:
                self._last_group_heartbeat = now
                try:
                    self.broker.heartbeat(f"{self.prefix}-agents",
                                          self._consumer.member_id)
                except Exception as exc:
                    self._c["heartbeat_failures"].inc()
                    log.debug("agent %s: broker heartbeat failed: %r",
                              self.agent_id, exc)
        self._watchdog()
        self._heartbeat_running()

    def _routable(self, task: TaskMessage) -> bool:
        """Defence against misrouted tasks (e.g. a producer using a different
        placement policy): a task this profile cannot run is bounced to its
        correct class topic instead of executing where it must not."""
        if self.profile is None or self.profile.can_run(task.resources):
            return True
        target = self.placement.route(self.prefix, task)
        if target in self._subscriptions:
            # rerouting would hand it straight back to us — run it rather
            # than loop (can only happen with an inconsistent policy).
            log.warning("agent %s: task %s is unroutable for profile %s — "
                        "executing anyway", self.agent_id, task.task_id,
                        self.profile)
            return True
        self._c["rerouted"].inc()
        log.warning("agent %s: rerouting misplaced task %s to %s",
                    self.agent_id, task.task_id, target)
        # give the lease up without a verdict: the rerouted record grants a
        # fresh one to whichever equipped agent leases it
        self.broker.forget_lease(task.task_id, self._consumer.member_id)
        now = time.time()
        self.broker.spans.add(task.task_id, "route", now, now,
                              attempt=task.attempt, agent=self.agent_id,
                              target=target)
        self._producer.send(target, task.to_dict(), key=task.task_id)
        return False

    # -- acceptance (subclass hook) --------------------------------------------

    def _accept(self, task: TaskMessage) -> None:
        raise NotImplementedError

    def _send_status(self, task: TaskMessage, status: TaskStatus | str,
                     **info: Any) -> None:
        upd = StatusUpdate(task_id=task.task_id,
                           status=str(getattr(status, "value", status)),
                           agent_id=self.agent_id, attempt=task.attempt,
                           info=info)
        self._producer.send(self.topics["jobs"], upd.to_dict(),
                            key=task.task_id)

    # -- watchdog (paper §3: cancel hung / timed-out tasks) -----------------------

    def _revoke_run(self, run: _Running, reason: str, *,
                    requeue: bool) -> bool:
        """Route one in-flight task through the unified reclamation
        primitive (:meth:`Broker.revoke_lease`): cancel + commit fence
        (+ requeue). False when no live lease exists — caller falls back to
        the plain cancel_event (legacy direct-wired agents)."""
        if not self.broker.revoke_lease(run.task.task_id, reason,
                                        requeue=requeue):
            return False
        self._c["revoked"].inc()
        return True

    def _watchdog(self) -> None:
        now = time.time()
        with self._lock:
            items = list(self._running.items())
        for tid, run in items:
            timeout = run.task.timeout_s or self.default_timeout_s
            if timeout is None:
                continue
            if now - run.started_at > timeout and not run.cancel.is_set():
                log.warning("agent %s: task %s exceeded %.1fs — revoking",
                            self.agent_id, tid, timeout)
                # revoke without requeue: the TIMEOUT status keeps the
                # redelivery *decision* where the attempt budget lives (the
                # MonitorAgent for flat tasks, the PipelineAgent's
                # RetryPolicy for campaign tasks); the revocation itself
                # fences this attempt's late verdict either way.
                if not self._revoke_run(run, RevokeReason.WATCHDOG,
                                        requeue=False):
                    self._cancel_task(run)
                self._send_status(run.task, TaskStatus.TIMEOUT,
                                  timeout_s=timeout)
        self._police_mem(items)

    def _police_mem(self, items: list[tuple[str, _Running]]) -> None:
        """Mem-overage policing: sample each running task's resident memory
        — kernel-accounted RSS growth by default, the task's
        ``report_mem()`` value when it self-reports (see
        :attr:`ClusterComputing.mem_used_mb`) — against its
        ``Resources.mem_mb`` request and revoke over-budget
        leases (admission packs requests; this polices *usage*). Flat tasks
        are requeued with a bumped attempt up to ``max_revoke_requeues``,
        then tolerated (mirroring the oversized-task admission escape
        hatch); campaign tasks get an ErrorMessage instead of a broker
        requeue so the owning PipelineAgent retries them on its journaled
        ``RetryPolicy`` budget."""
        for tid, run in items:
            comp = run.computing
            if comp is None or run.cancel.is_set() or run.mem_tolerated:
                continue
            used = float(getattr(comp, "mem_used_mb", 0.0) or 0.0)
            budget = run.task.resources.mem_mb
            if budget <= 0 or used <= budget:
                continue
            task = run.task
            if task.campaign_id is None \
                    and task.attempt >= self.max_revoke_requeues:
                run.mem_tolerated = True
                log.warning("agent %s: task %s over budget (%.0f > %d MB) "
                            "past %d requeues — tolerating", self.agent_id,
                            tid, used, budget, self.max_revoke_requeues)
                continue
            requeue = task.campaign_id is None
            if not self._revoke_run(run, RevokeReason.MEM_OVERAGE,
                                    requeue=requeue):
                continue
            self._c["mem_revoked"].inc()
            log.warning("agent %s: task %s exceeded mem budget "
                        "(%.0f > %d MB) — lease revoked%s", self.agent_id,
                        tid, used, budget, " and requeued" if requeue else "")
            self._send_status(task, TaskStatus.REVOKED,
                              reason=RevokeReason.MEM_OVERAGE,
                              mem_used_mb=used, mem_budget_mb=budget)
            if task.campaign_id is not None:
                err = ErrorMessage(
                    task_id=tid, agent_id=self.agent_id,
                    error=(f"mem overage: {used:.0f} MB used > "
                           f"{budget} MB requested"),
                    attempt=task.attempt)
                self._producer.send(self.topics["error"], err.to_dict(),
                                    key=tid)

    def _cancel_task(self, run: _Running) -> None:
        run.cancel.set()

    def _heartbeat_running(self) -> None:
        now = time.time()
        with self._lock:
            items = list(self._running.values())
        for run in items:
            if now - run.last_heartbeat >= self.heartbeat_interval_s:
                run.last_heartbeat = now
                self._send_status(run.task, TaskStatus.RUNNING,
                                  heartbeat=True, elapsed_s=now - run.started_at)

    # -- completion ------------------------------------------------------------------

    def _finish(self, task: TaskMessage, ok: bool) -> None:
        with self._lock:
            self._running.pop(task.task_id, None)
        if ok:
            self._c["completed"].inc()
        else:
            self._c["failed"].inc()

    # -- lifecycle ------------------------------------------------------------------

    def _drain(self) -> None:
        """On graceful stop, revoke in-flight work so it gets redelivered:
        flat tasks are requeued by the broker in the same critical section;
        campaign tasks are only cancelled+fenced (their PipelineAgent owns
        resubmission, exactly like the watchdog split)."""
        with self._lock:
            runs = list(self._running.values())
        for run in runs:
            if not self._revoke_run(run, RevokeReason.DRAIN,
                                    requeue=run.task.campaign_id is None):
                self._cancel_task(run)
        deadline = time.time() + 2.0
        while time.time() < deadline and self._in_flight() > 0:
            time.sleep(0.01)

    # -- graceful drain (autoscale scale-down) --------------------------------

    def request_drain(self, timeout_s: float | None = None) -> None:
        """Begin a graceful drain: the agent leaves its consumer group (the
        rebalance hands unread partitions to the survivors), requeues every
        deferred lease back onto its class topic, lets in-flight tasks run
        to completion — no cancellation, so nothing is re-executed — and
        then stops. Non-blocking; observe progress via :attr:`state` /
        :attr:`alive`. With ``timeout_s``, tasks still running at the
        deadline are cancelled (and redelivered by the watchdog) so the
        drain always terminates."""
        with self._lock:
            if timeout_s is not None:
                self._drain_deadline = time.time() + timeout_s
        self.broker.blackbox.record(
            "drain", agent=self.agent_id, in_flight=self._in_flight(),
            deferred=len(self._deferred), timeout_s=timeout_s)
        self._draining.set()

    def _drain_tick(self) -> bool:
        """One loop iteration while draining; True once fully drained."""
        if not self._drain_entered:
            self._drain_entered = True
            log.info("agent %s draining: %d in flight, %d deferred",
                     self.agent_id, self._in_flight(), len(self._deferred))
            # leave the group first: no new leases, and partitions this
            # agent held rebalance to the surviving members immediately
            self._consumer.close()
            self._flush_deferred()
        # in-flight tasks still need the watchdog and liveness heartbeats —
        # a silent draining agent would look dead to the monitor, which
        # would resubmit (and therefore double-run) its tasks
        self._watchdog()
        self._heartbeat_running()
        if self._drain_deadline is not None \
                and time.time() > self._drain_deadline:
            with self._lock:
                runs = list(self._running.values())
            for run in runs:
                if not run.cancel.is_set():
                    log.warning("agent %s drain deadline: revoking %s for "
                                "redelivery", self.agent_id, run.task.task_id)
                    if not self._revoke_run(
                            run, RevokeReason.DRAIN,
                            requeue=run.task.campaign_id is None):
                        self._cancel_task(run)
        return self._in_flight() == 0

    def _flush_deferred(self) -> None:
        """Requeue leased-but-unstarted tasks with the *same* attempt (a
        requeue, not a retry — the task never started, so another agent
        running it is not a duplicate execution). A deferred lease is still
        GRANTED, so :meth:`Broker.revoke_lease` with ``reason="drain"``
        requeues it onto the topic it was leased from in one atomic step;
        the manual reroute below only covers leases the broker no longer
        tracks. Without this, an agent removed mid-run would strand every
        task whose offset it had committed until a watchdog timeout."""
        while True:
            with self._lock:
                if not self._deferred:
                    return
                task = self._deferred.popleft()
            if not self.broker.revoke_lease(task.task_id, RevokeReason.DRAIN):
                try:
                    target = self.placement.route(self.prefix, task)
                except ValueError:
                    # unroutable under our policy: the bare topic, where the
                    # monitor's legacy-forwarding or watchdog picks it up
                    target = self.topics["new"]
                self._producer.send(target, task.to_dict(), key=task.task_id)
            self._send_status(task, TaskStatus.SUBMITTED,
                              requeued_by=self.agent_id)
            self._c["requeued"].inc()

    @property
    def draining(self) -> bool:
        return self._draining.is_set() and self.alive

    @property
    def state(self) -> str:
        """``running`` | ``draining`` | ``stopped`` | ``crashed``."""
        if self._crashed.is_set():
            return "crashed"
        if self._thread is None or not self._thread.is_alive():
            return "stopped"
        if self._draining.is_set():
            return "draining"
        return "running"

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def crash(self) -> None:
        """Test hook: die abruptly — no drain, no group leave, and no further
        messages of any kind (the producer is killed, as a dead process would
        be). The broker's session timeout + the MonitorAgent watchdog must
        recover the work."""
        self._crashed.set()
        self._producer.kill()
        with self._lock:
            for run in self._running.values():
                run.cancel.set()  # stop burning CPU; nothing is sent

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._crashed.is_set())

    def _mem_in_flight(self) -> int:
        with self._lock:
            return sum(r.task.resources.mem_mb
                       for r in self._running.values())

    def stats(self) -> dict:
        with self._lock:
            return {
                "agent_id": self.agent_id,
                "kind": self.kind,
                "state": self.state,
                "in_flight": len(self._running),
                "completed": self.tasks_completed,
                "failed": self.tasks_failed,
                "slots": self.slots,
                "oversubscribe": self.oversubscribe,
                "profile": (self.profile.to_dict()
                            if self.profile is not None else None),
                "subscriptions": list(self._subscriptions),
                "rerouted": self.tasks_rerouted,
                "deferred": self.tasks_deferred,
                "deferred_pending": len(self._deferred),
                "requeued": self.tasks_requeued,
                "revoked": self.tasks_revoked,
                "dropped_revoked": self.tasks_dropped_revoked,
                "mem_revoked": self.mem_revoked,
                "mem_in_flight_mb": sum(r.task.resources.mem_mb
                                        for r in self._running.values()),
                "heartbeat_failures": self.heartbeat_failures,
            }


class WorkerAgent(AgentBase):
    """Runs tasks directly in threads on the local machine (paper §3).

    With a declared profile, ``ResourceProfile.mem_mb`` is enforced at lease
    time: a task starts only while the sum of running requests fits the
    budget; otherwise it waits in the deferral queue — the workstation
    analogue of SimSlurm's per-node memory packing, instead of the old
    treat-it-as-a-hint behaviour."""

    kind = "worker"

    def _admit(self, task: TaskMessage) -> bool:
        if self.profile is None:
            return True
        need = task.resources.mem_mb
        cap = self.profile.mem_mb
        used = self._mem_in_flight()
        if used + need <= cap:
            return True
        if need > cap and not self._running:
            # the request can never fit this pool; running it best-effort on
            # an idle worker beats deadlocking the deferral queue (and
            # mirrors cpus-as-capacity-hint semantics, §5)
            log.warning("agent %s: task %s requests %d MB > profile budget "
                        "%d MB — admitting on idle worker", self.agent_id,
                        task.task_id, need, cap)
            return True
        return False

    def _accept(self, task: TaskMessage) -> None:
        cancel = threading.Event()
        member = self._consumer.member_id
        # GRANTED → RUNNING through the lease layer: a lease revoked while
        # the task waited in the deferral queue (drain flush, preemption,
        # operator scancel) was already requeued — starting it here would
        # double-run it.
        if not self.broker.claim_start(task.task_id, member, task.attempt,
                                       cancel):
            self._c["dropped_revoked"].inc()
            return
        run = _Running(task=task, cancel=cancel)
        with self._lock:
            self._running[task.task_id] = run
        self._send_status(task, TaskStatus.WAITING)

        def _target() -> None:
            if self._crashed.is_set():
                return
            cls = resolve_script(task.script)
            comp = cls(task, self._producer, self.prefix, self.agent_id,
                       cancel_event=cancel,
                       commit=lambda ok: self.broker.complete_lease(
                           task.task_id, member, task.attempt, ok=ok))
            run.computing = comp
            ok = False
            try:
                ok = comp.execute()
            finally:
                if not self._crashed.is_set():
                    self._finish(task, ok)
                else:
                    with self._lock:
                        self._running.pop(task.task_id, None)

        t = threading.Thread(target=_target,
                             name=f"{self.agent_id}-{task.task_id}",
                             daemon=True)
        run.thread = t
        t.start()


class ClusterAgent(AgentBase):
    """Submits tasks as (simulated) Slurm jobs and manages their lifecycle.

    ``slots`` is derived from the cluster size; ``oversubscribe`` > 0 enables
    the paper's keep-the-queue-full strategy. The agent holds **no** compute
    resources itself — between tasks, nodes are free for other users (the
    exact property that distinguishes KSA from Celery-style long-running
    workers, paper §2).
    """

    kind = "cluster"

    def __init__(self, broker: Broker, slurm: SimSlurm, prefix: str = "ksa",
                 *, oversubscribe: int | None = None, user: str = "ksa",
                 **kw: Any):
        slots = kw.pop("slots", slurm.total_cpus)
        if oversubscribe is None:
            oversubscribe = max(2, slots // 2)  # paper: always keep extras queued
        if "profile" not in kw:
            # derive routability/capacity from the simulated cluster's
            # hardware: a GPU-less Slurm partition must never lease GPU
            # stages, and the advertised mem budget is the cluster total
            # (per-node packing is SimSlurm's job).
            kw["profile"] = ResourceProfile(
                cpus=slurm.total_cpus,
                gpus=sum(n.gpus for n in slurm.nodes),
                mem_mb=sum(n.mem_mb for n in slurm.nodes))
        super().__init__(broker, prefix, slots=slots,
                         oversubscribe=oversubscribe, **kw)
        self.slurm = slurm
        self.user = user

    def _accept(self, task: TaskMessage) -> None:
        cancel = threading.Event()
        member = self._consumer.member_id
        run = _Running(task=task, cancel=cancel)

        def _on_revoke() -> None:
            # a revocation must also free the simulated node: scancel the
            # Slurm job (late-bound — the job id exists once sbatch returns)
            if run.slurm_job_id is not None:
                self.slurm.scancel(run.slurm_job_id)

        if not self.broker.claim_start(task.task_id, member, task.attempt,
                                       cancel, on_revoke=_on_revoke):
            self._c["dropped_revoked"].inc()
            return

        def _job(cancel_event: threading.Event | None = None) -> None:
            # runs inside a SimSlurm slot; honour both the agent's cancel and
            # Slurm's scancel/walltime event (merged view, no polling thread).
            if self._crashed.is_set():
                return
            merged = (cancel if cancel_event is None
                      else _AnyEvent(cancel, cancel_event))
            cls = resolve_script(task.script)
            comp = cls(task, self._producer, self.prefix, self.agent_id,
                       cancel_event=merged,
                       commit=lambda ok: self.broker.complete_lease(
                           task.task_id, member, task.attempt, ok=ok))
            run.computing = comp
            ok = False
            try:
                ok = comp.execute()
            finally:
                if not self._crashed.is_set():
                    self._finish(task, ok)
                else:
                    with self._lock:
                        self._running.pop(task.task_id, None)

        job_id = self.slurm.sbatch(
            _job, name=task.task_id, cpus=task.resources.cpus,
            gpus=task.resources.gpus, mem_mb=task.resources.mem_mb,
            walltime_s=task.timeout_s, user=self.user)
        run.slurm_job_id = job_id
        with self._lock:
            self._running[task.task_id] = run
        self._send_status(task, TaskStatus.WAITING, slurm_job_id=job_id)

    def _capacity(self) -> int:
        # lease only while the Slurm queue has room below the oversubscription
        # target: running-or-pending jobs < slots + oversubscribe.
        q = len(self.slurm.squeue(user=self.user))
        return (self.slots + self.oversubscribe) - max(q, self._in_flight())

    def _watchdog(self) -> None:
        super()._watchdog()
        self._police_slurm()

    def _police_slurm(self) -> None:
        """Slurm-side stops become lease revocations: a job the scheduler
        cancelled (walltime ``TO``) or an operator ``scancel``'d (``CA``)
        still holds a live lease — revoke it with ``reason="scancel"`` so
        the stale attempt is fenced at the broker instead of limping to a
        CANCELLED status the monitor has to notice going stale. Flat tasks
        are requeued in the same step; campaign resubmission stays with the
        PipelineAgent (watchdog split)."""
        with self._lock:
            items = list(self._running.items())
        for tid, run in items:
            if run.slurm_job_id is None:
                continue
            job = self.slurm.job(run.slurm_job_id)
            if job is None or job.state not in ("TO", "CA"):
                continue
            if self._revoke_run(run, RevokeReason.SCANCEL,
                                requeue=run.task.campaign_id is None):
                self._send_status(run.task, TaskStatus.REVOKED,
                                  reason=RevokeReason.SCANCEL,
                                  slurm_state=job.state,
                                  slurm_job_id=run.slurm_job_id)

    def _cancel_task(self, run: _Running) -> None:
        run.cancel.set()
        if run.slurm_job_id is not None:
            self.slurm.scancel(run.slurm_job_id)
