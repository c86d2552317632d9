"""Per-campaign / per-stage progress *views*.

These counters are the campaign-level analogue of the paper's per-task status
table (§3). Since the event-sourcing refactor the source of truth is the
:class:`~repro_torch.pipeline.state.CampaignState` reducer (folded from the
``PREFIX-campaigns`` journal); the :class:`StageStatus` counters live inside
it and :class:`CampaignStatus` is the snapshot the agent publishes on
``PREFIX-campaigns`` and the MonitorAgent mirrors into its REST API
(``/campaigns``). The ``RUNNING`` / ``COMPLETED`` / ``FAILED`` phase
constants moved to ``CampaignState`` in :mod:`repro_torch.pipeline.state`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping

_TERMINAL = ("COMPLETED", "FAILED")


@dataclasses.dataclass
class StageStatus:
    """Progress counters for one stage of one campaign.

    ``expected`` is fixed at submit time (source = #batches, map = 1:1 with
    upstream, join = 1); ``submitted``/``done``/``failed`` advance as the DAG
    executes; ``retried`` counts watchdog/error resubmissions;
    ``duplicates`` counts fenced duplicate results (late attempts);
    ``skipped`` counts tasks short-circuited by the stage's ``skip_when``
    conditional-edge predicate (they count toward completion — a fully
    skipped stage finishes the campaign instead of stalling it);
    ``revoked`` counts journaled lease revocations (``LeaseRevoked``, e.g.
    fair-share preemption) and ``revoke_pending`` how many of those are
    back in the ready queue awaiting a regrant — they no longer hold a
    slot, so they are excluded from ``in_flight``."""

    name: str
    script: str
    expected: int = 0
    submitted: int = 0
    done: int = 0
    failed: int = 0
    retried: int = 0
    duplicates: int = 0
    errors: int = 0
    skipped: int = 0
    revoked: int = 0
    revoke_pending: int = 0

    @property
    def in_flight(self) -> int:
        return max(0, self.submitted - self.done - self.failed
                   - self.revoke_pending)

    @property
    def complete(self) -> bool:
        return self.expected > 0 and self.done + self.skipped >= self.expected

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["in_flight"] = self.in_flight
        d["complete"] = self.complete
        return d


@dataclasses.dataclass
class CampaignStatus:
    campaign_id: str
    pipeline: str
    state: str = "RUNNING"
    stages: dict[str, StageStatus] = dataclasses.field(default_factory=dict)
    started_at: float = dataclasses.field(default_factory=time.time)
    finished_at: float | None = None
    failure: str | None = None
    preemptions: int = 0  # fair-share lease revocations this campaign took

    @property
    def done(self) -> bool:
        return self.state in _TERMINAL

    def progress(self) -> float:
        total = sum(s.expected for s in self.stages.values())
        if total == 0:
            return 0.0
        return sum(s.done + s.skipped for s in self.stages.values()) / total

    def elapsed_s(self) -> float:
        end = self.finished_at if self.finished_at is not None else time.time()
        return end - self.started_at

    def to_dict(self) -> dict:
        return {
            "campaign_id": self.campaign_id,
            "pipeline": self.pipeline,
            "state": self.state,
            "progress": round(self.progress(), 4),
            "elapsed_s": round(self.elapsed_s(), 3),
            "failure": self.failure,
            "preemptions": self.preemptions,
            "stages": {n: s.to_dict() for n, s in self.stages.items()},
        }

    @classmethod
    def from_snapshot(cls, d: Mapping[str, Any]) -> "CampaignStatus":
        """Rebuild from a ``to_dict`` snapshot (monitor-side mirroring)."""
        st = cls(campaign_id=d["campaign_id"], pipeline=d.get("pipeline", ""),
                 state=d.get("state", "RUNNING"),
                 preemptions=int(d.get("preemptions", 0)))
        for name, sd in d.get("stages", {}).items():
            st.stages[name] = StageStatus(
                name=name, script=sd.get("script", ""),
                expected=int(sd.get("expected", 0)),
                submitted=int(sd.get("submitted", 0)),
                done=int(sd.get("done", 0)),
                failed=int(sd.get("failed", 0)),
                retried=int(sd.get("retried", 0)),
                duplicates=int(sd.get("duplicates", 0)),
                errors=int(sd.get("errors", 0)),
                skipped=int(sd.get("skipped", 0)),
                revoked=int(sd.get("revoked", 0)),
                revoke_pending=int(sd.get("revoke_pending", 0)))
        return st
