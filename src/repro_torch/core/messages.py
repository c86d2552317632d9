"""Message schemas for the KSA control plane.

The paper (kafka-slurm-agent, §3/§5) routes four kinds of messages over four
Kafka topics:

  ``PREFIX-new``   — task descriptions to be computed,
  ``PREFIX-jobs``  — task status updates (SUBMITTED, WAITING, RUNNING, DONE, ...),
  ``PREFIX-done``  — results of finished tasks,
  ``PREFIX-error`` — error reports.

We keep the same four-topic layout and the same lifecycle, and add the fields
needed for at-least-once redelivery with attempt fencing (``attempt``) which the
paper lists as a future extension ("running multiple copies of each task ...
the current implementation of the status update mechanism is not designed to
handle this scenario").
"""
from __future__ import annotations

import dataclasses
import enum
import time
import uuid
from typing import Any, Mapping


class TaskStatus(str, enum.Enum):
    """Lifecycle from the paper's ``PREFIX-jobs`` topic (§5), plus the
    timeout/cancel states implied by the ClusterAgent watchdog (§3)."""

    SUBMITTED = "SUBMITTED"
    WAITING = "WAITING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    ERROR = "ERROR"
    TIMEOUT = "TIMEOUT"
    CANCELLED = "CANCELLED"
    # the lease layer (repro_torch.core.lease) took the task back: the attempt is
    # fenced and the record was (or will be) requeued by the revoker — the
    # monitor must NOT resubmit on this status, unlike TIMEOUT/CANCELLED.
    REVOKED = "REVOKED"
    # custom statuses may be emitted by computing scripts at any point (§5);
    # anything not in this enum is passed through verbatim as a string.


TERMINAL_STATUSES = frozenset(
    {TaskStatus.DONE, TaskStatus.ERROR, TaskStatus.CANCELLED}
)


def topic_names(prefix: str) -> Mapping[str, str]:
    """The paper's default topic layout (§5), plus the ``-campaigns`` topic
    carrying both :class:`CampaignEvent` progress snapshots and the pipeline
    agents' write-ahead journal of typed campaign events
    (:mod:`repro_torch.pipeline.state`) — the durable log that makes campaigns
    recoverable after an orchestrator crash.

    ``new`` is the *base* task-topic name. Resource-aware placement
    (:mod:`repro_torch.core.scheduling`) routes tasks to per-resource-class
    children of it (``PREFIX-new.cpu``, ``PREFIX-new.gpu``, ...); the flat
    :class:`~repro_torch.core.scheduling.SingleTopicPolicy` uses the base topic
    directly, which is the paper's original layout.

    ``telemetry`` is the telemetry plane's durable stream
    (:mod:`repro_torch.obs.telemetry`): periodic metric/span/event snapshot
    records, replayable like the journal so a restarted collector
    rebuilds its time-series store from the topic."""
    return {
        "new": f"{prefix}-new",
        "jobs": f"{prefix}-jobs",
        "done": f"{prefix}-done",
        "error": f"{prefix}-error",
        "campaigns": f"{prefix}-campaigns",
        "telemetry": f"{prefix}-telemetry",
    }


@dataclasses.dataclass
class Resources:
    """Resource request serialized with every task (paper §5: GPU, memory,
    number of CPUs). ``labels`` name extra resource classes (e.g. a
    ``bigmem`` pool) the placement policy can route on; ``tolerations`` let a
    task *accept* a tainted pool it does not otherwise request (a batch task
    tolerating the ``serve`` taint may be routed onto the serve pool) — see
    :mod:`repro_torch.core.scheduling`. ``mem_mb`` is enforced at lease time:
    workers admit tasks only while the sum of running requests fits their
    profile, and SimSlurm packs it per node alongside cpus/gpus.

    ``site`` pins the task to a named federation site (see
    :mod:`repro_torch.federation`): a :class:`~repro_torch.federation.SiteRouter` routes
    it to that site's bridge class instead of the generic cpu/gpu classes.
    ``input_mb`` is the task's input payload weight — the data-locality
    term a federated router charges against a WAN link's bandwidth when
    scoring a remote placement. Both default to the non-federated no-ops."""

    cpus: int = 1
    gpus: int = 0
    mem_mb: int = 1024
    labels: tuple = ()
    tolerations: tuple = ()
    site: str = ""
    input_mb: float = 0.0

    def __post_init__(self) -> None:
        self.labels = tuple(self.labels)
        self.tolerations = tuple(self.tolerations)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["labels"] = list(self.labels)
        d["tolerations"] = list(self.tolerations)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any] | None) -> "Resources":
        if d is None:
            return cls()
        return cls(**{k: d[k]
                      for k in ("cpus", "gpus", "mem_mb", "labels",
                                "tolerations", "site", "input_mb")
                      if k in d})


@dataclasses.dataclass
class TaskMessage:
    """A unit of work on ``PREFIX-new``.

    ``script`` names the computation (paper: the Python script to run; here:
    a registered ``ClusterComputing`` subclass or callable kind such as
    ``"train_chunk"``, ``"knot_batch"``, ``"serve_microbatch"``).
    ``params`` is the arbitrary JSON-serializable payload the paper passes to
    the computing script as its configuration.
    """

    task_id: str
    script: str
    params: dict = dataclasses.field(default_factory=dict)
    resources: Resources = dataclasses.field(default_factory=Resources)
    attempt: int = 0
    timeout_s: float | None = None
    submitted_at: float = dataclasses.field(default_factory=time.time)
    # campaign metadata (repro_torch.pipeline): which campaign/stage this task
    # belongs to and which upstream task_ids it consumed. Flat tasks leave
    # these unset — the control plane treats them identically either way.
    campaign_id: str | None = None
    stage: str | None = None
    dep_ids: list = dataclasses.field(default_factory=list)
    # trace context (repro_torch.obs): carried end-to-end so every control-plane
    # hop can attach spans to the same logical task. The submitter stamps
    # ``trace_id`` (defaults to the task_id) if unset; pipeline tasks also
    # carry ``parent`` = campaign_id. Redeliveries share the dict, which is
    # what links attempt spans into one chain.
    trace: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["resources"] = self.resources.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "TaskMessage":
        return cls(
            task_id=d["task_id"],
            script=d["script"],
            params=dict(d.get("params", {})),
            resources=Resources.from_dict(d.get("resources")),
            attempt=int(d.get("attempt", 0)),
            timeout_s=d.get("timeout_s"),
            submitted_at=float(d.get("submitted_at", time.time())),
            campaign_id=d.get("campaign_id"),
            stage=d.get("stage"),
            dep_ids=list(d.get("dep_ids", [])),
            trace=dict(d.get("trace") or {}),
        )

    def retry(self) -> "TaskMessage":
        """A redelivery copy with a bumped attempt counter (fencing token)."""
        nxt = dataclasses.replace(self, attempt=self.attempt + 1)
        return nxt


@dataclasses.dataclass
class StatusUpdate:
    """A record on ``PREFIX-jobs``."""

    task_id: str
    status: str
    agent_id: str = ""
    attempt: int = 0
    info: dict = dataclasses.field(default_factory=dict)
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "StatusUpdate":
        return cls(
            task_id=d["task_id"],
            status=str(d["status"]),
            agent_id=d.get("agent_id", ""),
            attempt=int(d.get("attempt", 0)),
            info=dict(d.get("info", {})),
            ts=float(d.get("ts", time.time())),
        )


@dataclasses.dataclass
class ResultMessage:
    """A record on ``PREFIX-done``. Bulk outputs stay off-broker (the paper
    ships structure batches via shared storage); ``result`` carries metrics and
    *references* (e.g. checkpoint paths)."""

    task_id: str
    agent_id: str
    result: dict = dataclasses.field(default_factory=dict)
    attempt: int = 0
    elapsed_s: float = 0.0
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ResultMessage":
        return cls(
            task_id=d["task_id"],
            agent_id=d.get("agent_id", ""),
            result=dict(d.get("result", {})),
            attempt=int(d.get("attempt", 0)),
            elapsed_s=float(d.get("elapsed_s", 0.0)),
            ts=float(d.get("ts", time.time())),
        )


@dataclasses.dataclass
class ErrorMessage:
    """A record on ``PREFIX-error``."""

    task_id: str
    agent_id: str
    error: str
    traceback: str = ""
    attempt: int = 0
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ErrorMessage":
        return cls(
            task_id=d["task_id"],
            agent_id=d.get("agent_id", ""),
            error=d.get("error", ""),
            traceback=d.get("traceback", ""),
            attempt=int(d.get("attempt", 0)),
            ts=float(d.get("ts", time.time())),
        )


@dataclasses.dataclass
class CampaignEvent:
    """A progress-snapshot record on ``PREFIX-campaigns``, published by a
    pipeline agent on every state transition. The MonitorAgent mirrors the
    latest snapshot per campaign into its ``/campaigns`` REST endpoint, so
    observability works across processes exactly like the paper's
    task-status flow (§3).

    The topic is shared with the write-ahead *journal* of typed campaign
    events (:mod:`repro_torch.pipeline.state`); ``kind`` discriminates the two
    record families (journal records carry ``kind="journal"``).
    ``recovered`` marks snapshots published by an agent that rebuilt this
    campaign from the journal after a crash."""

    campaign_id: str
    pipeline: str
    state: str  # RUNNING | COMPLETED | FAILED
    agent_id: str = ""
    stages: dict = dataclasses.field(default_factory=dict)
    recovered: bool = False
    preemptions: int = 0  # fair-share lease revocations taken so far
    kind: str = "snapshot"
    ts: float = dataclasses.field(default_factory=time.time)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CampaignEvent":
        return cls(
            campaign_id=d["campaign_id"],
            pipeline=d.get("pipeline", ""),
            state=str(d.get("state", "RUNNING")),
            agent_id=d.get("agent_id", ""),
            stages=dict(d.get("stages", {})),
            recovered=bool(d.get("recovered", False)),
            preemptions=int(d.get("preemptions", 0)),
            kind=str(d.get("kind", "snapshot")),
            ts=float(d.get("ts", time.time())),
        )


def new_task_id(prefix: str = "task") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:12]}"
