"""The user-facing computation API — the paper's ``ClusterComputing`` class.

Paper §5 / Fig. 3: "The script has to contain a class that extends the
built-in ClusterComputing class … parameters … will be serialized in the Kafka
message and then … read and made available as configuration parameters of the
task."  Users override :meth:`run`, read ``self.params``, and may call
:meth:`send_status` at any point ("computing scripts can also send status
updates at any moment of the computing process") and :meth:`send_results` /
automatic result forwarding on completion.

A registry maps ``script`` names in :class:`~repro_torch.core.messages.TaskMessage`
to ``ClusterComputing`` subclasses so agents can instantiate them in-process
(the container analogue of KSA launching a Python script as a Slurm job).
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Type

from repro_torch.obs import sample_rss_mb

from .broker import Broker, Producer
from .messages import (ErrorMessage, ResultMessage, StatusUpdate, TaskMessage,
                       TaskStatus, topic_names)


class TaskCancelled(Exception):
    """Raised inside a task when the agent's watchdog cancels it."""


class ClusterComputing:
    """Base class for user computations (paper Fig. 3).

    Subclasses override :meth:`run` and return a JSON-serializable result.
    ``self.params`` holds the deserialized task parameters; ``self.check_cancel()``
    cooperatively honours watchdog cancellation (the paper's ClusterAgent
    ``scancel``\\ s hung jobs — in-process tasks must observe the event).
    """

    def __init__(self, task: TaskMessage, producer: Producer, prefix: str,
                 agent_id: str, cancel_event: threading.Event | None = None,
                 commit: Callable[[bool], bool] | None = None):
        self.task = task
        self.task_id = task.task_id
        self.params: dict = task.params
        self.attempt = task.attempt
        self._producer = producer
        self._topics = topic_names(prefix)
        self.agent_id = agent_id
        self._cancel = cancel_event or threading.Event()
        # the lease commit gate (Broker.complete_lease via the agent): the
        # verdict may only be published while the lease is unrevoked — a
        # revoked lease's task was already requeued, so a late result or
        # error from this holder must be suppressed, not fenced downstream.
        self._commit_cb = commit
        # mem-overage policing input (the agent samples mem_used_mb against
        # Resources.mem_mb each watchdog tick). Default: kernel-accounted
        # RSS *growth* since this task started (repro_torch.obs.sample_rss_mb) —
        # a delta, because in-process tasks share the interpreter whose
        # baseline footprint is not this task's doing. report_mem() remains
        # as an explicit override for scripts that track their own usage.
        self._mem_reported: float | None = None
        self._rss_baseline_mb: float = sample_rss_mb()

    # -- API used by subclasses ------------------------------------------------

    def run(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def send_status(self, status: str | TaskStatus, **info: Any) -> None:
        upd = StatusUpdate(task_id=self.task_id,
                           status=str(getattr(status, "value", status)),
                           agent_id=self.agent_id, attempt=self.attempt,
                           info=info)
        self._producer.send(self._topics["jobs"], upd.to_dict(),
                            key=self.task_id)

    def send_results(self, result: dict, elapsed_s: float = 0.0) -> None:
        msg = ResultMessage(task_id=self.task_id, agent_id=self.agent_id,
                            result=result, attempt=self.attempt,
                            elapsed_s=elapsed_s)
        self._producer.send(self._topics["done"], msg.to_dict(),
                            key=self.task_id)

    def check_cancel(self) -> None:
        if self._cancel.is_set():
            raise TaskCancelled(self.task_id)

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def mem_used_mb(self) -> float:
        """Resident memory (MB) charged to this task: the explicit
        :meth:`report_mem` value when set, else the process RSS growth since
        the task was constructed (kernel-accounted via ``/proc/self/status``,
        so a misbehaving task cannot hide by simply not reporting)."""
        if self._mem_reported is not None:
            return self._mem_reported
        return max(0.0, sample_rss_mb() - self._rss_baseline_mb)

    @mem_used_mb.setter
    def mem_used_mb(self, mem_mb: float) -> None:
        self._mem_reported = float(mem_mb)

    def report_mem(self, mem_mb: float) -> None:
        """Report the task's current resident memory, overriding the RSS
        sampler. Long-running scripts that track their own usage (structure
        batches, feature caches) should call this so the agent's
        mem-overage policing can compare usage against the task's
        ``Resources.mem_mb`` request and revoke the lease instead of
        letting one task blow the pool budget."""
        self._mem_reported = float(mem_mb)

    def _commit(self, ok: bool) -> bool:
        """Commit the verdict through the lease gate; False = fenced."""
        if self._commit_cb is None:
            return True
        return self._commit_cb(ok)

    # -- driver used by agents ---------------------------------------------------

    def execute(self) -> bool:
        """Full lifecycle: RUNNING → run() → DONE + result (or ERROR).
        Returns True on success. Every verdict passes the lease commit gate
        first: if the lease was revoked mid-run, the (already requeued)
        task's stale result/error is suppressed and only a REVOKED status
        is emitted."""
        t0 = time.time()
        self.send_status(TaskStatus.RUNNING)
        try:
            result = self.run()
            self.check_cancel()
        except TaskCancelled:
            if not self._commit(False):
                # the cancel came from a lease revocation: the revoker
                # already owns redelivery (requeue or journaled retry), so
                # the monitor must not treat this as a recoverable CANCELLED
                self.send_status(TaskStatus.REVOKED)
            else:
                self.send_status(TaskStatus.CANCELLED)
            return False
        except Exception as exc:  # noqa: BLE001 - error flow is a feature
            if not self._commit(False):
                self.send_status(TaskStatus.REVOKED, error=repr(exc))
                return False
            err = ErrorMessage(task_id=self.task_id, agent_id=self.agent_id,
                               error=repr(exc), traceback=traceback.format_exc(),
                               attempt=self.attempt)
            self._producer.send(self._topics["error"], err.to_dict(),
                                key=self.task_id)
            self.send_status(TaskStatus.ERROR, error=repr(exc))
            return False
        elapsed = time.time() - t0
        if not self._commit(True):
            self.send_status(TaskStatus.REVOKED, elapsed_s=elapsed)
            return False
        if not isinstance(result, dict):
            result = {"value": result}
        self.send_results(result, elapsed_s=elapsed)
        self.send_status(TaskStatus.DONE, elapsed_s=elapsed)
        return True


# --------------------------------------------------------------------------
# Script registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, Type[ClusterComputing]] = {}


def register_script(name: str) -> Callable[[Type[ClusterComputing]], Type[ClusterComputing]]:
    def deco(cls: Type[ClusterComputing]) -> Type[ClusterComputing]:
        _REGISTRY[name] = cls
        return cls
    return deco


def resolve_script(name: str) -> Type[ClusterComputing]:
    if name not in _REGISTRY:
        raise KeyError(f"no ClusterComputing registered for script={name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_scripts() -> list[str]:
    return sorted(_REGISTRY)


@register_script("sleep")
class SleepComputing(ClusterComputing):
    """Trivial built-in task used by tests and latency benchmarks."""

    def run(self) -> Any:
        duration = float(self.params.get("duration", 0.01))
        deadline = time.time() + duration
        while time.time() < deadline:
            self.check_cancel()
            time.sleep(min(0.005, max(deadline - time.time(), 0.0)))
        return {"slept": duration}


@register_script("fail")
class FailComputing(ClusterComputing):
    """Built-in task that fails N times then succeeds — exercises the
    error flow + redelivery (at-least-once) machinery."""

    _counts: dict[str, int] = {}
    _lock = threading.Lock()

    def run(self) -> Any:
        fail_times = int(self.params.get("fail_times", 1))
        with self._lock:
            seen = self._counts.get(self.task_id, 0)
            self._counts[self.task_id] = seen + 1
        if seen < fail_times:
            raise RuntimeError(f"induced failure {seen + 1}/{fail_times}")
        return {"succeeded_after": seen}


@register_script("hang")
class HangComputing(ClusterComputing):
    """Hangs until cancelled — exercises the watchdog (paper: "if a task
    hangs or exceeds the predefined timeout, the ClusterAgent intervenes")."""

    def run(self) -> Any:
        while True:
            self.check_cancel()
            time.sleep(0.005)


@register_script("memhog")
class MemHogComputing(ClusterComputing):
    """Reports a resident set that overshoots the task's request —
    exercises mem-overage lease revocation. ``peak_mb`` is the reported
    RSS; from attempt ``calm_after_attempt`` onward the task behaves and
    stays at its requested budget (so a revoked-and-requeued hog can be
    observed completing on a later attempt)."""

    def run(self) -> Any:
        duration = float(self.params.get("duration", 0.3))
        peak = float(self.params.get("peak_mb", 0.0))
        calm_after = int(self.params.get("calm_after_attempt", 1))
        misbehave = self.attempt < calm_after
        deadline = time.time() + duration
        while time.time() < deadline:
            self.check_cancel()
            if misbehave:
                self.report_mem(peak)
            time.sleep(0.005)
        return {"attempt": self.attempt, "peak_mb": self.mem_used_mb}
