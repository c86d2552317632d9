"""Resource-aware placement and lease scheduling for the KSA control plane.

The paper routes every task to every agent through one shared ``PREFIX-new``
consumer group (§3), which makes ``Resources.gpus`` decorative: any agent may
lease a GPU stage. ParaFold (arXiv:2111.06340) shows that the CPU/GPU stage
split is the key to AlphaFold-scale throughput, and the Summit deployment
(arXiv:2201.10024) shows ensemble workflows need placement-aware scheduling
rather than a flat task bag. This module makes placement a first-class,
pluggable concept:

* :class:`ResourceProfile` — what an *agent pool* can run (cpus, gpus, mem,
  labels, taints). Agents subscribe only to the per-resource-class topics
  (``PREFIX-new.<class>``) their profile can serve, so a GPU stage can never
  be leased by a CPU-only agent — it queues on the GPU class topic instead.
  ``mem_mb`` is an admission budget enforced at lease time, and ``taints``
  make a pool exclusive (k8s-style: a ``serve``-tainted pool refuses plain
  batch work unless the task tolerates the taint via
  ``Resources.tolerations``).
* :class:`PlacementPolicy` — maps tasks to class topics and profiles to
  subscriptions. :class:`ResourceClassPolicy` (the default) splits ``cpu`` /
  ``gpu`` plus arbitrary label classes; :class:`SingleTopicPolicy` reproduces
  the paper's flat shared topic (every agent sees every task) and is kept as
  the baseline for ``benchmarks/bench_routing.py``.
* :class:`LeasePolicy` — how multiple campaigns' ready tasks drain into
  ``-new`` capacity. :class:`FairShare` (smooth weighted round-robin keyed by
  ``campaign_id``) replaces the first-come FIFO contention;
  :class:`FifoLease` preserves the old strict arrival order.

The :class:`~repro_torch.core.submitter.Submitter`, the agents, the
:class:`~repro_torch.core.monitor.MonitorAgent`, and the
:class:`~repro_torch.pipeline.agent.PipelineAgent` all take the same policy object
(usually wired once through :class:`repro_torch.cluster.KsaCluster`).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .messages import Resources, TaskMessage


# --------------------------------------------------------------------------
# Agent-side capability declaration
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResourceProfile:
    """What one agent pool is equipped to run.

    ``cpus`` is a capacity hint (packing is enforced by slots / SimSlurm);
    ``mem_mb`` is the pool's admission budget — workers lease a task only
    while the sum of running requests fits it (mem-aware admission, the same
    packing SimSlurm applies per node for cpus/gpus); ``gpus`` and ``labels``
    are *routability* dimensions — they decide which resource-class topics
    the agent subscribes to, and :meth:`can_run` checks only those, so a task
    asking for more CPUs than one agent advertises still runs (slower), while
    a task asking for a GPU on a CPU-only pool never does.

    ``taints`` make a pool *exclusive*: a tainted pool subscribes only to the
    class topics its taints/labels name and refuses any task that neither
    carries the taint as a label nor tolerates it
    (``Resources.tolerations``) — e.g. a ``serve``-tainted pool never drains
    plain cpu batch work (the ROADMAP label-taint follow-on).
    """

    cpus: int = 1
    gpus: int = 0
    mem_mb: int = 1024
    labels: tuple[str, ...] = ()
    taints: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "labels", tuple(self.labels))
        object.__setattr__(self, "taints", tuple(self.taints))

    def can_run(self, res: "Resources") -> bool:
        """Routability check: GPU *capability*, labels, and taints. GPU
        count, like cpus/mem, is a capacity hint (SimSlurm packs it per
        node); what a CPU-only pool can never do is run a GPU task at all —
        and what a tainted pool must never do is run work that neither asks
        for nor tolerates the taint."""
        if res.gpus > 0 and self.gpus <= 0:
            return False
        if not set(res.labels) <= set(self.labels):
            return False
        accepted = set(res.labels) | set(res.tolerations)
        return set(self.taints) <= accepted

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["labels"] = list(self.labels)
        d["taints"] = list(self.taints)
        return d


# --------------------------------------------------------------------------
# Placement: task -> class topic, profile -> subscriptions
# --------------------------------------------------------------------------


def class_topic(prefix: str, cls: str) -> str:
    """The per-resource-class task topic, ``PREFIX-new.<class>``."""
    return f"{prefix}-new.{cls}"


class PlacementPolicy:
    """Pluggable task-routing strategy.

    Implementations answer three questions for one broker ``prefix``:
    which task topics exist (:meth:`topics`), which topic one task goes to
    (:meth:`route`), and which topics one agent profile consumes
    (:meth:`subscriptions`).
    """

    def topics(self, prefix: str) -> tuple[str, ...]:
        raise NotImplementedError

    def route(self, prefix: str, task: "TaskMessage") -> str:
        raise NotImplementedError

    def subscriptions(self, prefix: str,
                      profile: ResourceProfile | None) -> tuple[str, ...]:
        raise NotImplementedError


class ResourceClassPolicy(PlacementPolicy):
    """Default policy: per-resource-class topics ``cpu`` / ``gpu`` plus any
    ``extra_classes`` (label-routed pools, e.g. ``bigmem``).

    Routing: a task labelled with a known class goes to that class; else
    ``gpus > 0`` routes to ``gpu``, everything else to ``cpu`` (the ParaFold
    featurize/predict split). Subscriptions: ``profile=None`` means a legacy
    universal agent (subscribes to every class — the paper's behaviour);
    GPU-capable profiles serve ``gpu`` and, when ``gpu_takes_cpu`` (default),
    also drain ``cpu`` work when idle (work conservation); CPU-only profiles
    serve ``cpu`` alone, which is what makes GPU tasks queue rather than
    misroute when the GPU pool is saturated.
    """

    def __init__(self, extra_classes: tuple[str, ...] = (), *,
                 gpu_takes_cpu: bool = True):
        self.extra_classes = tuple(extra_classes)
        self.gpu_takes_cpu = gpu_takes_cpu
        self._classes = ("cpu", "gpu") + self.extra_classes

    def classes(self) -> tuple[str, ...]:
        return self._classes

    def classify(self, task: "TaskMessage") -> str:
        res = task.resources
        if res.labels:
            for lb in res.labels:
                if lb in self._classes:
                    return lb
            # a label names a pool; silently routing a bigmem task to the
            # plain cpu class would execute it on hardware it asked to avoid
            raise ValueError(
                f"task {task.task_id}: labels {list(res.labels)} name no "
                f"resource class (known: {list(self._classes)}); declare "
                f"them via ResourceClassPolicy(extra_classes=...)")
        # a gpu demand always wins — a toleration is permission, not a
        # demand, and must never land a GPU task on whatever hardware backs
        # the tolerated pool
        if res.gpus > 0:
            return "gpu"
        # route tolerating cpu work to the tolerated (usually tainted) class
        # so that pool *can* serve it; unknown tolerations simply fall
        # through to the default class.
        for tl in res.tolerations:
            if tl in self._classes:
                return tl
        return "cpu"

    def topics(self, prefix: str) -> tuple[str, ...]:
        return tuple(class_topic(prefix, c) for c in self._classes)

    def route(self, prefix: str, task: "TaskMessage") -> str:
        return class_topic(prefix, self.classify(task))

    def subscriptions(self, prefix: str,
                      profile: ResourceProfile | None) -> tuple[str, ...]:
        if profile is None:
            return self.topics(prefix)
        if profile.taints:
            # exclusive pool: only the class topics its taints/labels name —
            # a serve-tainted agent never even subscribes to the plain cpu
            # class, so it cannot drain untolerated batch work.
            keep = set(profile.labels) | set(profile.taints)
            topics = tuple(class_topic(prefix, c) for c in self._classes
                           if c in keep)
            if not topics:
                # same fail-fast contract as classify() for unknown labels:
                # a silently idle worker is a misconfiguration, not a pool
                raise ValueError(
                    f"profile taints {list(profile.taints)} name no "
                    f"resource class (known: {list(self._classes)}); "
                    f"declare them via ResourceClassPolicy(extra_classes=...)")
            return topics
        classes: list[str] = []
        if profile.gpus > 0:
            classes.append("gpu")
            if self.gpu_takes_cpu:
                classes.append("cpu")
        else:
            classes.append("cpu")
        classes += [lb for lb in profile.labels
                    if lb in self._classes and lb not in classes]
        return tuple(class_topic(prefix, c) for c in classes)


class SingleTopicPolicy(PlacementPolicy):
    """The paper's flat design: one shared ``PREFIX-new`` topic, every agent
    load-balances every task. Kept for comparison benchmarks and drop-in
    compatibility with external producers that write to the bare topic."""

    def topics(self, prefix: str) -> tuple[str, ...]:
        return (f"{prefix}-new",)

    def route(self, prefix: str, task: "TaskMessage") -> str:
        return f"{prefix}-new"

    def subscriptions(self, prefix: str,
                      profile: ResourceProfile | None) -> tuple[str, ...]:
        return self.topics(prefix)


# --------------------------------------------------------------------------
# Lease scheduling: which campaign's ready tasks drain next
# --------------------------------------------------------------------------


class LeasePolicy:
    """Picks which campaign submits its next ready task when several compete
    for ``-new`` capacity. ``candidates`` maps campaign_id -> weight for
    every campaign that has a submittable ready task right now."""

    def select(self, candidates: Mapping[str, float]) -> str:
        raise NotImplementedError

    def preempt(self, shares: Mapping[str, tuple[float, int, bool, bool]]
                ) -> str | None:
        """The preemption hook: name the campaign whose longest-running
        lease should be revoked (and requeued) to make room, or ``None``
        to leave everything running. ``shares`` maps campaign_id ->
        ``(weight, in_flight, has_ready_waiting, preemptible)`` over the
        live campaigns — fairness is judged over all of them, but only a
        ``preemptible`` campaign (one with ``RetryPolicy.max_preemptions``
        budget left) may be named. Submission-time arbitration alone
        cannot reclaim a slot a long-running task already holds — this
        hook can. Default: never preempt (``FifoLease`` keeps the paper's
        run-to-completion behaviour)."""
        return None

    def forget(self, campaign_id: str) -> None:
        """Drop any per-campaign state (campaign finished/evicted)."""


class FifoLease(LeasePolicy):
    """Strict arrival order: the earliest-registered campaign with ready work
    drains first — the paper's first-come contention, kept as the baseline."""

    def select(self, candidates: Mapping[str, float]) -> str:
        return next(iter(candidates))


class FairShare(LeasePolicy):
    """Smooth weighted round-robin over campaigns (nginx's swrr): each pick,
    every candidate's credit grows by its weight; the max-credit candidate is
    picked and pays the total weight back. Weights 3:1 yield the interleaving
    A A B A, A A B A, ... — task completions track the weight ratio instead
    of first-come-first-served campaign ordering.

    **Preemptive** fair share: when some campaign is *severely* over its
    share — holding more than ``preempt_factor`` times its weighted slice of
    the total in-flight leases — while another campaign with ready work sits
    below its own slice, :meth:`preempt` names the over-share campaign; the
    PipelineAgent then revokes its longest-running lease
    (``Broker.revoke_lease(reason="preempt")``, journaled as
    ``LeaseRevoked``) and the freed capacity drains through the normal
    weighted round-robin. Bounded per campaign by
    ``RetryPolicy.max_preemptions``."""

    def __init__(self, preempt_factor: float = 2.0) -> None:
        if not (preempt_factor > 1.0):
            raise ValueError(
                f"preempt_factor must exceed 1.0 (got {preempt_factor!r}); "
                f"at 1.0 every campaign at exactly its fair share would be "
                f"preempted")
        self.preempt_factor = preempt_factor
        self._credit: dict[str, float] = {}

    def select(self, candidates: Mapping[str, float]) -> str:
        total = sum(candidates.values())
        best: str | None = None
        for cid, weight in candidates.items():
            credit = self._credit.get(cid, 0.0) + weight
            self._credit[cid] = credit
            if best is None or credit > self._credit[best]:
                best = cid
        assert best is not None, "select() called with no candidates"
        self._credit[best] -= total
        return best

    def preempt(self, shares: Mapping[str, tuple[float, int, bool, bool]]
                ) -> str | None:
        total_w = sum(w for w, _, _, _ in shares.values())
        total_in = sum(f for _, f, _, _ in shares.values())
        if total_w <= 0 or total_in <= 0:
            return None
        fair = {cid: w / total_w * total_in
                for cid, (w, _, _, _) in shares.items()}
        # someone must actually be starved: ready work waiting while the
        # campaign sits below its slice — otherwise a lone campaign using
        # the whole pool is work conservation, not unfairness
        if not any(ready and f < fair[cid]
                   for cid, (_, f, ready, _) in shares.items()):
            return None
        # fairness is computed over every campaign, but only a preemptible
        # one may pay — an opted-out hog must not shield a lesser (but
        # still severely over-share) opted-in peer from preemption
        worst, worst_ratio = None, self.preempt_factor
        for cid, (_, f, _, preemptible) in shares.items():
            if f <= 0 or not preemptible:
                continue
            ratio = f / max(fair[cid], 1e-9)
            if ratio > worst_ratio:
                worst, worst_ratio = cid, ratio
        return worst

    def forget(self, campaign_id: str) -> None:
        self._credit.pop(campaign_id, None)
