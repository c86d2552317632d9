"""Synchronous campaign front-end.

``run_campaign`` is the pipeline analogue of the paper's submit-then-wait
scripts (§5): it spins a :class:`PipelineAgent` (or reuses one), submits the
campaign, streams progress to a callback, and returns the joined final result
once the DAG has drained. Worker/Cluster/Monitor agents are expected to be
running against the same broker+prefix — the driver orchestrates, it does not
execute.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable, Mapping

from repro_torch.core.broker import Broker

from .agent import PipelineAgent, PipelineError
from .spec import PipelineSpec
from .state import CampaignState
from .status import CampaignStatus


@dataclasses.dataclass
class CampaignResult:
    campaign_id: str
    status: CampaignStatus
    results: dict[str, list]   # per-stage results, task-creation order
    final: Any                 # the terminal (usually join) stage's result
    elapsed_s: float


def run_campaign(spec: PipelineSpec, items: Iterable | None = None, *,
                 broker: Broker, prefix: str = "ksa",
                 params: Mapping[str, Any] | None = None,
                 agent: PipelineAgent | None = None,
                 default_task_timeout_s: float | None = None,
                 placement: Any = None,
                 weight: float = 1.0,
                 progress: Callable[[CampaignStatus], None] | None = None,
                 progress_interval_s: float = 0.25,
                 timeout_s: float = 600.0) -> CampaignResult:
    """Run one campaign to completion and return its joined result.

    Raises :class:`PipelineError` if the campaign fails (a stage exhausted its
    retry budget) and :class:`TimeoutError` if it does not finish in
    ``timeout_s``. ``placement`` routes stage tasks to resource-class topics
    (defaults to the standard cpu/gpu split); ``weight`` is the campaign's
    fair-share weight when the agent serves several campaigns at once.
    """
    own_agent = agent is None
    if own_agent:
        agent = PipelineAgent(
            broker, prefix, placement=placement,
            default_task_timeout_s=default_task_timeout_s).start()
    try:
        t0 = time.time()
        cid = agent.submit_campaign(spec, items, params=params, weight=weight)
        deadline = t0 + timeout_s
        while True:
            st = agent.wait(cid, timeout=progress_interval_s)
            if progress is not None:
                progress(st)
            if st.done:
                break
            if time.time() > deadline:
                raise TimeoutError(
                    f"campaign {cid} did not finish in {timeout_s:.0f}s "
                    f"(progress {st.progress():.0%})")
        if st.state == CampaignState.FAILED:
            raise PipelineError(f"campaign {cid} failed: {st.failure}")
        return CampaignResult(
            campaign_id=cid,
            status=st,
            results=agent.results(cid),
            final=agent.final_result(cid),
            elapsed_s=time.time() - t0,
        )
    finally:
        if own_agent:
            agent.stop()
