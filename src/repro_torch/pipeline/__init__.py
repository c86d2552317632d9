"""repro_torch.pipeline — DAG campaign orchestration over the KSA control plane.

The paper's production workloads are multi-stage *campaigns*, not flat task
bags: AlphaKnot 2.0 (§4) runs structure ingest → HOMFLY-PT screening → knot
localization over millions of AlphaFold models, with each stage exhibiting a
different resource profile. This subsystem turns the broker/agent machinery
of §3 into a campaign engine, following the heterogeneous-stage split of
ParaFold (arXiv:2111.06340, CPU featurize vs GPU predict) and the
fan-out/fan-in orchestration of the Summit proteome-scale deployment
(arXiv:2201.10024).

Class → paper mapping:

* :class:`~repro_torch.pipeline.spec.Stage` / :class:`~repro_torch.pipeline.spec.PipelineSpec`
  — declarative DAG of registered ``ClusterComputing`` scripts (§5, Fig. 3),
  with per-stage ``Resources`` (§5's CPU/GPU/memory request, used here to
  route stages to differently-equipped pools), fan-out batching (§4's
  "batches of 4,000 structures"), join barriers, and retry/timeout policy.
* :class:`~repro_torch.pipeline.spec.RetryPolicy` — bounds the at-least-once
  resubmission loop (§3's watchdog + the safe-multiple-attempts extension
  the paper lists as future work).
* :class:`~repro_torch.pipeline.state.CampaignState` — the **event-sourced core**:
  campaign progress is a pure reducer folding a typed journal
  (``CampaignSubmitted`` / ``StageDispatched`` / ``LeaseGranted`` /
  ``TaskDone`` / ``TaskFailed`` / ``StageSkipped`` / ``BarrierReleased``)
  written ahead of every action to the ``PREFIX-campaigns`` topic. DAG
  semantics are therefore deterministic, broker-free unit-testable, and —
  crucially — recoverable: an orchestrator ``kill -9`` mid-campaign is
  resumed by folding the journal back (:meth:`PipelineAgent.recover` /
  ``KsaCluster.recover()``).
* :class:`~repro_torch.pipeline.agent.PipelineAgent` — the thin executor over that
  log, and a peer of the MonitorAgent (§3): subscribes to
  ``PREFIX-done``/``PREFIX-error``, journals + folds events, submits leased
  tasks, fences duplicate results by first-wins per task so a barrier never
  double-fires, enforces per-stage ``max_in_flight`` backpressure, arbitrates
  concurrent campaigns through a
  :class:`~repro_torch.core.scheduling.LeasePolicy` (FairShare weighted
  round-robin by default; per-campaign ``weight=`` at submit), honours
  ``Stage.skip_when`` conditional edges (skips cascade, are journaled, and
  count toward completion), and publishes progress snapshots on
  ``PREFIX-campaigns`` alongside the journal.

Campaigns are normally driven through :class:`repro_torch.cluster.KsaCluster`
(``c.run_campaign(spec, items)`` / ``c.recover(specs)``), which wires the
pipeline agent to the same broker, prefix, and placement policy as the
execution pools.
* :class:`~repro_torch.pipeline.status.CampaignStatus` /
  :class:`~repro_torch.pipeline.status.StageStatus` — the campaign-level analogue of
  §3's task status table, surfaced via the MonitorAgent REST API
  (``/campaigns``).
* :func:`~repro_torch.pipeline.driver.run_campaign` — the synchronous submit-and-wait
  front-end matching the paper's §5 submission scripts.
"""
from .agent import PipelineAgent, PipelineError
from .driver import CampaignResult, run_campaign
from .spec import PipelineSpec, RetryPolicy, SpecError, Stage
from .state import (BarrierReleased, CampaignSnapshot, CampaignState,
                    CampaignSubmitted, JournalEvent, LeaseGranted,
                    LeaseRevoked, StageDispatched, StageSkipped, TaskDone,
                    TaskFailed)
from .status import CampaignStatus, StageStatus

__all__ = [
    "BarrierReleased", "CampaignResult", "CampaignSnapshot", "CampaignState",
    "CampaignStatus",
    "CampaignSubmitted", "JournalEvent", "LeaseGranted", "LeaseRevoked",
    "PipelineAgent",
    "PipelineError", "PipelineSpec", "RetryPolicy", "SpecError", "Stage",
    "StageDispatched", "StageSkipped", "StageStatus", "TaskDone",
    "TaskFailed", "run_campaign",
]
