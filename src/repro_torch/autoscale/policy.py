"""Scaling policies — the *decide* half of the autoscale control loop.

A policy maps one pool's sensed :class:`PoolSignal` to a desired agent
count. Policies are **stateless by contract**: every clock the decision
depends on (idle duration, time since the last scale action) arrives inside
the signal, so a policy is a pure function and its hysteresis/cooldown
behaviour is unit-testable without threads, brokers, or sleeps
(tests/test_autoscale.py drives synthetic signal sequences through it).

The default :class:`TargetBacklogPolicy` implements the queue-theoretic
rule APACE (arXiv:2308.07954) uses for elastic AlphaFold serving — size the
pool so the per-slot backlog stays near a target — with the guard rails a
bang-bang controller needs on a real queue:

* **hysteresis** — the scale-up condition (backlog per slot above ``high``)
  and the scale-down condition (pool completely idle for ``idle_grace_s``)
  cannot both hold, and a backlog oscillating anywhere between them changes
  nothing;
* **cooldowns** — consecutive scale actions are separated by
  ``up_cooldown_s`` / ``down_cooldown_s``, so a burst landing faster than
  agents can start (or a SimSlurm node can spin up) does not over-provision,
  and a brief gap between bursts does not tear the pool down;
* **bounded step-down** — the pool shrinks one agent per decision (each
  shrink is a graceful drain; stepping down gently keeps capacity available
  while the drain completes), while scale-up jumps straight to the demand
  estimate (queues punish under-provisioning harder than over-provisioning);
* **scale-to-zero** — a pool whose ``min_agents`` is 0 (typically a tainted
  ``serve`` pool) drops to zero agents when idle and wakes on the first
  queued task regardless of cooldown: the cold start already costs enough.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from repro_torch.core.scheduling import ResourceProfile


class AutoscaleError(ValueError):
    """Raised for malformed pool specs / configs."""


# --------------------------------------------------------------------------
# What one elastic pool is (declarative)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One elastic agent pool serving one resource class.

    ``cls`` names the resource class whose ``PREFIX-new.<cls>`` backlog
    drives the pool ("cpu", "gpu", or a label/taint class the placement
    policy knows). ``kind`` selects the actuator: ``"worker"`` pools grow by
    in-process :class:`~repro_torch.core.agents.WorkerAgent`\\ s with ``slots``
    each; ``"slurm"`` pools grow by attaching a fresh
    :class:`~repro_torch.core.simslurm.SimSlurm` (built from the ``slurm`` kwargs,
    e.g. ``dict(nodes=1, cpus_per_node=4, spinup_s=2.0)``) behind a
    ClusterAgent — the spin-up latency then shows up as backlog that the
    cooldown must ride out rather than double-provision against.

    ``profile`` defaults by class: plain cpu/gpu worker profiles sized to
    ``slots``, and for any other class a tainted, labelled profile — i.e. an
    exclusive pool that only drains tolerated/labelled work, the natural
    scale-to-zero candidate (``min_agents=0``).
    """

    cls: str
    kind: str = "worker"                     # "worker" | "slurm"
    min_agents: int = 0
    max_agents: int = 4
    slots: int = 1
    profile: ResourceProfile | None = None
    slurm: Mapping[str, Any] | None = None   # SimSlurm kwargs (kind="slurm")
    agent_kw: Mapping[str, Any] | None = None

    def __post_init__(self) -> None:
        if self.kind not in ("worker", "slurm"):
            raise AutoscaleError(f"pool {self.cls!r}: unknown kind "
                                 f"{self.kind!r} (worker|slurm)")
        if self.min_agents < 0 or self.max_agents < max(1, self.min_agents):
            raise AutoscaleError(
                f"pool {self.cls!r}: need 0 <= min_agents <= max_agents "
                f"(got {self.min_agents}..{self.max_agents})")
        if self.slots <= 0:
            raise AutoscaleError(f"pool {self.cls!r}: slots must be positive")
        if self.slurm is not None and self.kind != "slurm":
            raise AutoscaleError(
                f"pool {self.cls!r}: slurm kwargs on a worker pool")

    def resolve_profile(self) -> ResourceProfile:
        """The profile each grown agent declares (worker pools)."""
        if self.profile is not None:
            return self.profile
        if self.cls == "cpu":
            return ResourceProfile(cpus=self.slots, mem_mb=1024 * self.slots)
        if self.cls == "gpu":
            return ResourceProfile(cpus=self.slots, gpus=1,
                                   mem_mb=1024 * self.slots)
        # label/taint class: an exclusive pool that serves only its class
        return ResourceProfile(cpus=self.slots, mem_mb=1024 * self.slots,
                               labels=(self.cls,), taints=(self.cls,))


# --------------------------------------------------------------------------
# What the controller senses (per pool, per tick)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PoolSignal:
    """One pool's sensed state at one control-loop tick. All times are
    durations relative to the tick (no wall-clock), keeping policies pure."""

    cls: str
    backlog: int              # queue depth on the class topic (unleased)
    in_flight: int            # running + deferred leases on pool agents
    agents: int               # live, non-draining agents
    slots: int                # slots per agent
    drain_rate: float         # tasks/s the agents group is committing
    idle_for_s: float         # how long backlog == 0 and in_flight == 0
    since_scale_up_s: float   # time since this pool last grew
    since_scale_down_s: float  # time since this pool last shrank

    @property
    def backlog_per_slot(self) -> float:
        return self.backlog / max(1, self.agents * self.slots)


# --------------------------------------------------------------------------
# Policies
# --------------------------------------------------------------------------


class ScalingPolicy:
    """Maps a :class:`PoolSignal` to a desired agent count for one pool.
    The controller clamps the answer to ``[min_agents, max_agents]`` and
    enacts the difference (grow = spawn agents, shrink = graceful drain)."""

    def desired(self, sig: PoolSignal, spec: PoolSpec) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class TargetBacklogPolicy(ScalingPolicy):
    """Target backlog-per-slot with hysteresis and cooldowns (see module
    docstring). ``target`` is the backlog depth per slot the pool is sized
    for when growing (2.0 ≈ the paper's keep-the-queue-full oversubscription
    strategy, applied to pool size instead of the Slurm queue); ``high`` is
    the per-slot backlog that triggers growth."""

    target: float = 2.0
    high: float = 1.0
    idle_grace_s: float = 0.5
    up_cooldown_s: float = 0.25
    down_cooldown_s: float = 0.5

    def __post_init__(self) -> None:
        if self.target <= 0 or self.high <= 0:
            raise AutoscaleError("target and high must be positive")

    def desired(self, sig: PoolSignal, spec: PoolSpec) -> int:
        demand = sig.backlog + sig.in_flight
        if demand <= 0:
            # fully idle: step down one agent at a time, after the idle
            # grace AND the down cooldown (hysteresis band: a backlog that
            # flickers 0 ↔ below-high changes nothing either way)
            if (sig.idle_for_s >= self.idle_grace_s
                    and sig.since_scale_down_s >= self.down_cooldown_s
                    and sig.since_scale_up_s >= self.down_cooldown_s):
                return max(spec.min_agents, sig.agents - 1)
            return max(spec.min_agents, sig.agents)
        if sig.agents == 0:
            # scale-to-zero wake: queued work on an empty pool overrides
            # every cooldown — the cold start is already the price
            return self._sized_for(demand, spec)
        if sig.backlog_per_slot > self.high \
                and sig.since_scale_up_s >= self.up_cooldown_s:
            return max(sig.agents + 1, self._sized_for(demand, spec))
        return sig.agents  # in the hysteresis band: hold

    def _sized_for(self, demand: int, spec: PoolSpec) -> int:
        want = math.ceil(demand / (self.target * spec.slots))
        return max(1, min(spec.max_agents, want))


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Wiring for :class:`~repro_torch.autoscale.controller.AutoscaleController`,
    passed as ``KsaCluster(autoscale=AutoscaleConfig(...))``.

    ``drain_timeout_s`` bounds each scale-down drain: a task still running
    at the deadline is cancelled and redelivered (at-least-once) instead of
    pinning the drained agent forever. ``rate_window_s`` is the lookback for
    the drain-rate estimate served on ``/autoscale``."""

    pools: tuple[PoolSpec, ...] = ()
    policy: ScalingPolicy = dataclasses.field(
        default_factory=TargetBacklogPolicy)
    interval_s: float = 0.05
    drain_timeout_s: float | None = 30.0
    rate_window_s: float = 2.0
    history: int = 512            # backlog samples retained per pool

    def __post_init__(self) -> None:
        object.__setattr__(self, "pools", tuple(self.pools))
        if not self.pools:
            raise AutoscaleError("AutoscaleConfig needs at least one PoolSpec")
        seen = set()
        for p in self.pools:
            if p.cls in seen:
                raise AutoscaleError(f"duplicate pool for class {p.cls!r}")
            seen.add(p.cls)
        if self.interval_s <= 0:
            raise AutoscaleError("interval_s must be positive")
