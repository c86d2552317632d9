"""Declarative DAG campaign specifications.

A :class:`PipelineSpec` is a directed acyclic graph of :class:`Stage`\\ s, each
naming a registered ``ClusterComputing`` script. Three stage shapes cover the
paper's campaign patterns (§4) and the ParaFold/Summit decompositions the
pipeline subsystem is modeled on:

* **source** (no ``depends_on``): seeded from the campaign's input items,
  optionally fanned out into batches of ``fan_out`` items (the paper's
  "batches of 4,000 structures, each batch submitted as a single task"),
* **map** (one dependency, ``join=False``): one downstream task per completed
  upstream task; the upstream result rides along as ``params["upstream"]``,
* **join** (``join=True``, one or more dependencies): a fan-in barrier — fires
  exactly one task once *every* task of every upstream stage has a result,
  with ``params["upstream"] = {stage_name: [results...]}``.

Per-stage :class:`~repro_torch.core.messages.Resources` route heterogeneous stages
to differently-equipped pools (ParaFold's CPU-featurize vs GPU-predict split);
:class:`RetryPolicy` bounds attempts and sets the watchdog timeout;
``max_in_flight`` bounds concurrent tasks per stage (backpressure).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Mapping, Sequence

from repro_torch.core.messages import Resources


class SpecError(ValueError):
    """Raised when a PipelineSpec is malformed (cycle, bad dep, ...)."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-stage fault-tolerance knobs.

    ``max_attempts`` counts total submissions of one task (initial + retries);
    ``timeout_s`` is the pipeline agent's per-task watchdog — a task with no
    result after this long is resubmitted with a bumped attempt (straggler
    mitigation; duplicate results are fenced downstream).

    ``max_preemptions`` opts the campaign into **preemptive fair share**: how
    many times the lease policy may revoke one of the campaign's running
    leases (``Broker.revoke_lease(reason="preempt")``, journaled as
    ``LeaseRevoked``) to hand the slot to a starved peer. The bound is
    per *campaign* — the effective cap is the maximum over its stages —
    and preemptions do **not** consume the ``max_attempts`` retry budget
    (a requeue is not a failure). 0 (the default) disables preemption of
    this campaign entirely."""

    max_attempts: int = 3
    timeout_s: float | None = None
    max_preemptions: int = 0


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    script: str
    depends_on: tuple[str, ...] = ()
    join: bool = False
    fan_out: int | None = None        # source stages: items per task
    params: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    resources: Resources = dataclasses.field(default_factory=Resources)
    max_in_flight: int | None = None  # backpressure bound (None = unbounded)
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    timeout_s: float | None = None    # per-task execution cancel (agent-side)
    # conditional edge / early-exit (ROADMAP): when the predicate holds on
    # the upstream result, the task is *skipped* instead of submitted — the
    # stage (and the campaign) completes with the skip counted, never FAILED.
    # Map stages: called with the one upstream task's result dict. Join
    # stages: called with the assembled {stage: [results...]} mapping
    # (skipped upstream tasks contribute no entry). Skips cascade: a map
    # task downstream of a skipped task is itself skipped.
    skip_when: Callable[[Any], bool] | None = None

    def __post_init__(self) -> None:
        if isinstance(self.depends_on, str):  # common foot-gun
            object.__setattr__(self, "depends_on", (self.depends_on,))
        else:
            object.__setattr__(self, "depends_on", tuple(self.depends_on))
        if self.join and not self.depends_on:
            raise SpecError(f"join stage {self.name!r} needs dependencies")
        if not self.join and len(self.depends_on) > 1:
            raise SpecError(
                f"map stage {self.name!r} may have exactly one dependency "
                f"(got {self.depends_on}); use join=True to fan in")
        if self.fan_out is not None:
            if self.depends_on:
                raise SpecError(
                    f"fan_out is only valid on source stages ({self.name!r})")
            if self.fan_out <= 0:
                raise SpecError(f"fan_out must be positive ({self.name!r})")
        if self.max_in_flight is not None and self.max_in_flight <= 0:
            raise SpecError(f"max_in_flight must be positive ({self.name!r})")
        if self.skip_when is not None and self.is_source:
            raise SpecError(
                f"skip_when needs an upstream result ({self.name!r} is a "
                f"source stage)")

    @property
    def is_source(self) -> bool:
        return not self.depends_on


class PipelineSpec:
    """A validated DAG of stages with helpers the agent plans from."""

    def __init__(self, name: str, stages: Sequence[Stage]):
        self.name = name
        self.stages: dict[str, Stage] = {}
        for st in stages:
            if st.name in self.stages:
                raise SpecError(f"duplicate stage name {st.name!r}")
            self.stages[st.name] = st
        if not self.stages:
            raise SpecError("pipeline has no stages")
        for st in self.stages.values():
            for dep in st.depends_on:
                if dep not in self.stages:
                    raise SpecError(
                        f"stage {st.name!r} depends on unknown stage {dep!r}")
        self._order = self._toposort()
        if not any(st.is_source for st in self.stages.values()):
            raise SpecError("pipeline has no source stage")

    def _toposort(self) -> list[str]:
        indeg = {n: len(st.depends_on) for n, st in self.stages.items()}
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order: list[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for m, st in self.stages.items():
                if n in st.depends_on:
                    indeg[m] -= 1
                    if indeg[m] == 0:
                        ready.append(m)
        if len(order) != len(self.stages):
            cyclic = sorted(set(self.stages) - set(order))
            raise SpecError(f"pipeline has a cycle through {cyclic}")
        return order

    # -- planning helpers ---------------------------------------------------

    def topological(self) -> list[Stage]:
        return [self.stages[n] for n in self._order]

    def sources(self) -> list[Stage]:
        return [st for st in self.topological() if st.is_source]

    def downstream(self, name: str) -> list[Stage]:
        return [st for st in self.topological() if name in st.depends_on]

    def terminals(self) -> list[Stage]:
        consumed = {d for st in self.stages.values() for d in st.depends_on}
        return [st for st in self.topological() if st.name not in consumed]

    def expected_counts(self, n_items: int) -> dict[str, int]:
        """Tasks per stage for a campaign over ``n_items`` input items —
        fully determined up front: source = #batches, map = its upstream's
        count (1:1), join = 1."""
        out: dict[str, int] = {}
        for st in self.topological():
            if st.is_source:
                if st.fan_out is None:
                    out[st.name] = 1
                else:
                    out[st.name] = max(1, math.ceil(n_items / st.fan_out))
            elif st.join:
                out[st.name] = 1
            else:
                out[st.name] = out[st.depends_on[0]]
        return out

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "stages": [
                {
                    "name": st.name, "script": st.script,
                    "depends_on": list(st.depends_on), "join": st.join,
                    "fan_out": st.fan_out,
                    "max_in_flight": st.max_in_flight,
                    "resources": st.resources.to_dict(),
                    "retry": dataclasses.asdict(st.retry),
                    "conditional": st.skip_when is not None,
                }
                for st in self.topological()
            ],
        }
