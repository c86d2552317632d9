"""SiteBridgeAgent — the home-side proxy that executes tasks on a remote
site.

A bridge is an ordinary :class:`~repro_torch.core.agents.AgentBase` member of the
home consumer group, so every task it leases holds a real home-broker
lease — the home lease stays **the** authority for the task's lifecycle,
which is what makes cross-site execution exactly-once without a distributed
protocol:

* the bridge registers itself via :meth:`Broker.register_holder_site`, so
  its leases are stamped with the remote site and the site's WAN-tolerant
  deadline (:class:`~repro_torch.core.lease.LeaseTolerance`) — the home watchdogs
  wait longer before presuming a relay dead;
* a home-side revocation (watchdog, preemption, drain) fires the lease's
  cancel event exactly as for a local worker; the relay thread notices,
  revokes the remote copy (``requeue=False`` — the home revoker owns the
  redelivery decision), and drops whatever verdict the remote produces;
* the remote verdict only reaches the home ``-done``/``-error`` topics
  through the home :meth:`Broker.complete_lease` gate, so a verdict racing
  a revocation is fenced at the same single commit point as everything
  else — a task preempted from site A and re-run locally can never also
  commit from site B.

The relay models the WAN explicitly: shipping the task charges
``latency + input_mb/bandwidth`` against the site's link, the result pays
the return latency, and a partitioned link blocks relays *and* the
bridge's home-bound heartbeats (the bridge cannot vouch for an execution
it cannot see) — which is exactly the silence the per-site lease deadline
must tolerate.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import TYPE_CHECKING, Any

from repro_torch.core.agents import AgentBase, _Running
from repro_torch.core.lease import RevokeReason
from repro_torch.core.messages import (ErrorMessage, ResultMessage, TaskMessage,
                                 TaskStatus)

from .site import Site

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.cluster import KsaCluster
    from repro_torch.core.broker import Broker

log = logging.getLogger(__name__)

__all__ = ["SiteBridgeAgent"]


class SiteBridgeAgent(AgentBase):
    """Relays leased tasks to one remote site and their verdicts back.

    ``role`` distinguishes *affinity* bridges (taint-exclusive profile —
    only ``site.<name>``-pinned work, always running) from *spill* bridges
    (cpu/gpu-class profile, raised and drained by the
    :class:`~repro_torch.federation.SpilloverController`). ``slots`` bounds how
    many relays are in flight — effectively the WAN-side admission window
    onto the remote site."""

    kind = "bridge"

    def __init__(self, broker: "Broker", remote: "KsaCluster", site: Site,
                 prefix: str = "ksa", *, role: str = "affinity",
                 deadline_s: float | None = None,
                 remote_poll_s: float = 0.02, **kw: Any):
        kw.setdefault("agent_id",
                      f"bridge-{site.name}-{role}-{id(self) & 0xffff:04x}")
        super().__init__(broker, prefix, **kw)
        if remote.monitor is None:
            raise ValueError(
                f"site {site.name!r}: bridges need the remote cluster's "
                f"monitor (built with monitor=False)")
        self.remote = remote
        self.site = site
        self.role = role
        self.deadline_s = deadline_s
        self.remote_poll_s = remote_poll_s
        events = broker.metrics.counter(
            "ksa_bridge_events_total",
            "Per-bridge cross-site relay events",
            labels=("bridge", "site", "event"))
        self._b = {e: events.labels(bridge=self.agent_id, site=site.name,
                                    event=e)
                   for e in ("relayed", "returned", "errored", "fenced",
                             "remote_revoked")}
        # stamp this member's leases with the site + WAN deadline before the
        # first lease is granted
        broker.register_holder_site(self._consumer.member_id, site.name,
                                    deadline_s)

    # -- AgentBase overrides ------------------------------------------------

    def _routable(self, task: TaskMessage) -> bool:
        # the bridge is a forwarder, not an executor: whatever it leases is
        # shipped whole, and the *remote* site's own placement policy routes
        # it to the right class topic there — profile can_run() semantics
        # (which would bounce site-pinned work lacking the taint label) do
        # not apply
        return True

    def _heartbeat_running(self) -> None:
        # a partitioned link means the bridge cannot observe the remote
        # execution, so it must not vouch for it either — heartbeats stop,
        # staleness accrues at the home monitor, and the stamped per-site
        # deadline (not the uniform one) decides when that silence becomes
        # a revocation
        if not self.site.link.up:
            return
        super()._heartbeat_running()

    def _watchdog(self) -> None:
        # same split as AgentBase._watchdog, but the WAN-tolerant deadline
        # scales the task timeout: a relay legitimately spends link time on
        # top of compute time. No mem policing — bridges run nothing.
        now = time.time()
        with self._lock:
            items = list(self._running.items())
        for tid, run in items:
            timeout = run.task.timeout_s or self.default_timeout_s
            if timeout is None:
                continue
            allowed = self.site.tolerance.deadline(timeout) or timeout
            if now - run.started_at > allowed and not run.cancel.is_set():
                log.warning("bridge %s: relay %s exceeded %.1fs — revoking",
                            self.agent_id, tid, allowed)
                if not self._revoke_run(run, RevokeReason.WATCHDOG,
                                        requeue=False):
                    self._cancel_task(run)
                self._send_status(run.task, TaskStatus.TIMEOUT,
                                  timeout_s=allowed, site=self.site.name)

    def stop(self, timeout: float = 5.0) -> None:
        super().stop(timeout=timeout)
        self.broker.unregister_holder_site(self._consumer.member_id)

    # -- relay ------------------------------------------------------------

    def _accept(self, task: TaskMessage) -> None:
        cancel = threading.Event()
        member = self._consumer.member_id
        if not self.broker.claim_start(task.task_id, member, task.attempt,
                                       cancel):
            self._c["dropped_revoked"].inc()
            return
        run = _Running(task=task, cancel=cancel)
        with self._lock:
            self._running[task.task_id] = run
        self._send_status(task, TaskStatus.WAITING, site=self.site.name,
                          bridge=self.agent_id)
        t = threading.Thread(target=self._relay, args=(run,),
                             name=f"{self.agent_id}-{task.task_id}",
                             daemon=True)
        run.thread = t
        t.start()

    def _wait_link(self, duration_s: float, cancel: threading.Event) -> bool:
        """Spend ``duration_s`` of link *uptime* (transfer does not progress
        across a partition); False if the home lease is cancelled first."""
        remaining = duration_s
        while True:
            if cancel.is_set():
                return False
            if not self.site.link.up:
                time.sleep(0.005)
                continue
            if remaining <= 0:
                return True
            step = min(0.01, remaining)
            time.sleep(step)
            remaining -= step

    def _remote_copy(self, task: TaskMessage) -> TaskMessage:
        """The task as the remote site sees it: re-routed locally there
        (the site pin is consumed by crossing the link) and detached from
        its campaign — the remote control plane retries it on its own flat
        budget, while DAG bookkeeping stays with the home PipelineAgent,
        which matches the relayed result by task_id."""
        copy = TaskMessage.from_dict(task.to_dict())
        copy.resources.site = ""
        copy.campaign_id = None
        copy.stage = None
        copy.dep_ids = []
        return copy

    def _abort_remote(self, task: TaskMessage, submitted: bool,
                      reason: str) -> None:
        """Cross-site revocation: fence/cancel the remote copy so a home
        revocation cannot leave site B finishing (and committing) work that
        site A's requeue is about to re-run. Revocation is control
        traffic — delivered in-process even while the data link is
        partitioned."""
        if not submitted:
            return
        try:
            if self.remote.broker.revoke_lease(task.task_id, reason,
                                               requeue=False):
                self._b["remote_revoked"].inc()
        except Exception:  # pragma: no cover - defensive
            log.exception("bridge %s: remote revoke of %s failed",
                          self.agent_id, task.task_id)

    def _drop_fenced(self, task: TaskMessage) -> None:
        with self._lock:
            self._running.pop(task.task_id, None)
        self._b["fenced"].inc()
        self._c["dropped_revoked"].inc()

    def _relay(self, run: _Running) -> None:
        task, cancel = run.task, run.cancel
        member = self._consumer.member_id
        started = time.time()
        submitted = False
        try:
            # 1. ship the input across the link
            input_mb = float(getattr(task.resources, "input_mb", 0.0) or 0.0)
            if not self._wait_link(self.site.link.one_way_s(input_mb),
                                   cancel):
                self._abort_remote(task, submitted, RevokeReason.PREEMPT)
                self._drop_fenced(task)
                return
            # 2. submit on the remote site (same task_id/attempt: the remote
            # lease table fences its own local races; the home lease fences
            # the federation-level ones)
            try:
                self.remote.submitter.submit_task(self._remote_copy(task))
            except Exception as exc:
                self._fail_home(run, started,
                                f"remote submit failed at site "
                                f"{self.site.name}: {exc!r}")
                return
            submitted = True
            self._b["relayed"].inc()
            self._send_status(task, TaskStatus.RUNNING, site=self.site.name,
                              relayed=True)
            # 3. await the remote verdict (blind while the link is down)
            while True:
                if cancel.is_set():
                    self._abort_remote(task, submitted, RevokeReason.PREEMPT)
                    self._drop_fenced(task)
                    return
                if not self.site.link.up:
                    time.sleep(self.remote_poll_s)
                    continue
                e = self.remote.monitor.task(task.task_id)
                if e is not None and e.done:
                    break
                if e is not None and not e.done and e.errors and \
                        e.status == TaskStatus.ERROR.value and \
                        e.attempts_seen >= self.remote.max_attempts:
                    # the remote site exhausted its own retry budget
                    self._fail_home(run, started,
                                    f"site {self.site.name}: "
                                    f"{e.errors[-1].get('error', 'failed')}")
                    return
                time.sleep(self.remote_poll_s)
            # 4. the result pays the return latency
            if not self._wait_link(self.site.link.one_way_s(), cancel):
                self._abort_remote(task, submitted, RevokeReason.PREEMPT)
                self._drop_fenced(task)
                return
            # 5. home commit gate — the single exactly-once authority
            if not self.broker.complete_lease(task.task_id, member,
                                              task.attempt, ok=True):
                # revoked while the result was in flight: the stale verdict
                # must not leave the bridge, and the remote lease is already
                # terminal (it finished) so there is nothing to revoke
                self._drop_fenced(task)
                return
            res = ResultMessage(task_id=task.task_id, agent_id=self.agent_id,
                                result=dict(e.result or {}),
                                attempt=task.attempt,
                                elapsed_s=time.time() - started)
            self._producer.send(self.topics["done"], res.to_dict(),
                                key=task.task_id)
            self._b["returned"].inc()
            self._finish(task, True)
        except Exception:  # pragma: no cover - defensive
            log.exception("bridge %s: relay of %s crashed", self.agent_id,
                          task.task_id)
            self._abort_remote(task, submitted, RevokeReason.WATCHDOG)
            with self._lock:
                self._running.pop(task.task_id, None)

    def _fail_home(self, run: _Running, started: float, error: str) -> None:
        task = run.task
        member = self._consumer.member_id
        if not self.broker.complete_lease(task.task_id, member, task.attempt,
                                          ok=False):
            self._drop_fenced(task)
            return
        err = ErrorMessage(task_id=task.task_id, agent_id=self.agent_id,
                           error=error, attempt=task.attempt)
        self._producer.send(self.topics["error"], err.to_dict(),
                            key=task.task_id)
        self._b["errored"].inc()
        self._finish(task, False)
