"""repro_torch.autoscale — backlog-driven elastic pool scaling with graceful drain.

The paper runs statically provisioned agents (§4: one ClusterAgent per
cluster, sized by hand), so a bursty campaign leaves the GPU pool idle while
the CPU screen stage backlogs — the utilization gap ParaFold
(arXiv:2111.06340) closes by splitting CPU/GPU phases and APACE
(arXiv:2308.07954) closes by provisioning AlphaFold elastically. This
subsystem closes it inside the KSA control plane:

* **sense** — per-resource-class queue depth and drain rate from
  :meth:`repro_torch.core.broker.Broker.queue_stats` (incremental counters on the
  produce/commit paths; no record scans);
* **decide** — a pluggable, *pure* :class:`~repro_torch.autoscale.policy.ScalingPolicy`;
  the default :class:`~repro_torch.autoscale.policy.TargetBacklogPolicy` targets a
  backlog-per-slot with hysteresis, cooldowns, min/max bounds, and
  scale-to-zero for tainted pools;
* **act** — :class:`~repro_torch.autoscale.controller.AutoscaleController` grows
  pools through :class:`~repro_torch.cluster.KsaCluster` (``add_worker`` /
  ``add_slurm``, including SimSlurm node spin-up latency as a visible cold
  start) and shrinks them through the agents' graceful drain
  (:meth:`~repro_torch.core.agents.AgentBase.request_drain`): subscriptions stop,
  deferred leases are requeued, in-flight tasks finish, then the agent
  deregisters — no task lost, none double-run.

Usage through the facade::

    from repro_torch.autoscale import AutoscaleConfig, PoolSpec

    cfg = AutoscaleConfig(pools=(
        PoolSpec("cpu", min_agents=1, max_agents=4, slots=2),
        PoolSpec("gpu", min_agents=0, max_agents=4, slots=1),
    ))
    with KsaCluster(autoscale=cfg) as c:
        c.run_campaign(spec, items)     # pools follow the backlog
        print(c.autoscaler.status())    # also on GET /autoscale (http=True)
"""
from .controller import AutoscaleController
from .policy import (AutoscaleConfig, AutoscaleError, PoolSignal, PoolSpec,
                     ScalingPolicy, TargetBacklogPolicy)
from .rate import RateTracker

__all__ = [
    "AutoscaleConfig", "AutoscaleController", "AutoscaleError", "PoolSignal",
    "PoolSpec", "RateTracker", "ScalingPolicy", "TargetBacklogPolicy",
]
