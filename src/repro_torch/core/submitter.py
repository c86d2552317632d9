"""Submitter — sends task descriptions to the task topics (paper §3).

"The submission of any task involves setting the necessary parameters and then
using the built-in Submitter class to send the appropriate messages" (§5).
Batching helpers mirror the AlphaKnot campaign pattern (§4): "the entire set
of AlphaFold structures was divided into batches of 4,000, with each batch
submitted as a single task".

Unlike the paper's single shared ``PREFIX-new`` topic, each task is routed to
the per-resource-class topic its :class:`~repro_torch.core.messages.Resources`
require (``PREFIX-new.cpu`` / ``PREFIX-new.gpu`` / label classes) through a
pluggable :class:`~repro_torch.core.scheduling.PlacementPolicy`, so a GPU stage can
only ever be leased by a GPU-capable pool. Pass
:class:`~repro_torch.core.scheduling.SingleTopicPolicy` to recover the paper's flat
layout.
"""
from __future__ import annotations

import time
from typing import Any, Sequence

from .broker import Broker, Producer
from .messages import (Resources, StatusUpdate, TaskMessage, TaskStatus,
                       new_task_id, topic_names)
from .scheduling import PlacementPolicy, ResourceClassPolicy


class Submitter:
    """``partitioner`` picks how task records map to partitions of their
    class topic: ``"hash"`` (default, kafka-like — stable per task id) or
    ``"balanced"`` (least-loaded partition — evens out the per-member share
    under the sticky group assignor, which sets a campaign's makespan).
    Status updates always hash so each task's timeline stays ordered."""

    def __init__(self, broker: Broker, prefix: str = "ksa", *,
                 placement: PlacementPolicy | None = None,
                 partitioner: str = "hash"):
        if partitioner not in ("hash", "balanced"):
            raise ValueError(f"unknown partitioner {partitioner!r} "
                             f"(expected 'hash' or 'balanced')")
        self.broker = broker
        self.prefix = prefix
        self.topics = topic_names(prefix)
        self.placement = placement or ResourceClassPolicy()
        self.partitioner = partitioner
        self._producer = Producer(broker)
        for t in self.topics.values():
            broker.create_topic(t)
        for t in self.placement.topics(prefix):
            broker.create_topic(t)

    def submit(self, script: str, task_id: str | None = None, *,
               params: dict | None = None, cpus: int = 1, gpus: int = 0,
               mem_mb: int = 1024, labels: Sequence[str] = (),
               timeout_s: float | None = None,
               attempt: int = 0, resources: Resources | None = None,
               campaign_id: str | None = None, stage: str | None = None,
               dep_ids: list | None = None) -> str:
        """Submit one task (paper §5: script name, task ID, resources, and any
        number of extra parameters). ``campaign_id``/``stage``/``dep_ids``
        tag tasks emitted by the repro_torch.pipeline DAG orchestrator."""
        task = TaskMessage(
            task_id=task_id or new_task_id(script),
            script=script,
            params=dict(params or {}),
            resources=resources or Resources(cpus=cpus, gpus=gpus,
                                             mem_mb=mem_mb,
                                             labels=tuple(labels)),
            timeout_s=timeout_s,
            attempt=attempt,
            campaign_id=campaign_id,
            stage=stage,
            dep_ids=list(dep_ids or []),
        )
        return self.submit_task(task)

    def submit_task(self, task: TaskMessage) -> str:
        """Submit a fully-built :class:`TaskMessage` (used by the pipeline
        agent, which constructs stage tasks itself). The placement policy
        picks the class topic; the SUBMITTED status update carries the routed
        topic for observability."""
        task.trace.setdefault("trace_id", task.task_id)
        topic = self.placement.route(self.prefix, task)
        now = time.time()
        self.broker.spans.add(task.task_id, "submit", now, now,
                              attempt=task.attempt, topic=topic,
                              trace_id=task.trace["trace_id"],
                              campaign=task.campaign_id)
        self._producer.send(topic, task.to_dict(), key=task.task_id,
                            partition=self._task_partition(topic))
        self._producer.send(
            self.topics["jobs"],
            StatusUpdate(task_id=task.task_id,
                         status=TaskStatus.SUBMITTED.value,
                         attempt=task.attempt,
                         info={"topic": topic}).to_dict(),
            key=task.task_id)
        return task.task_id

    def _task_partition(self, topic: str) -> int | None:
        if self.partitioner != "balanced":
            return None  # keyed hash, the broker's default
        return self.broker.least_loaded_partition(topic)

    def resubmit(self, task: TaskMessage) -> str:
        """Redeliver a task with a bumped attempt (straggler mitigation /
        at-least-once path used by the MonitorAgent watchdog). Routed through
        the same placement policy as the original submission."""
        nxt = task.retry()
        nxt.trace.setdefault("trace_id", nxt.task_id)
        topic = self.placement.route(self.prefix, nxt)
        now = time.time()
        self.broker.spans.add(nxt.task_id, "submit", now, now,
                              attempt=nxt.attempt, topic=topic,
                              trace_id=nxt.trace["trace_id"],
                              campaign=nxt.campaign_id, resubmitted=True)
        self._producer.send(topic, nxt.to_dict(), key=nxt.task_id,
                            partition=self._task_partition(topic))
        self._producer.send(
            self.topics["jobs"],
            StatusUpdate(task_id=nxt.task_id,
                         status=TaskStatus.SUBMITTED.value,
                         attempt=nxt.attempt,
                         info={"resubmitted": True}).to_dict(),
            key=nxt.task_id)
        return nxt.task_id

    def submit_batches(self, script: str, items: Sequence[Any], *,
                       batch_size: int, params: dict | None = None,
                       id_prefix: str | None = None,
                       **resource_kw: Any) -> list[str]:
        """Campaign-style submission: split ``items`` into batches of
        ``batch_size`` and submit one task per batch (paper §4, batches of
        4000 AlphaFold structures)."""
        ids = []
        base = id_prefix or script
        for i in range(0, len(items), batch_size):
            batch = list(items[i:i + batch_size])
            p = dict(params or {})
            p["batch"] = batch
            p["batch_index"] = i // batch_size
            ids.append(self.submit(script, task_id=f"{base}-b{i // batch_size:06d}",
                                   params=p, **resource_kw))
        return ids
