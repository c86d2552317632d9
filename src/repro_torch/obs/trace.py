"""Bounded in-memory span store: per-task lifecycle traces.

Every task carries a trace context in its :class:`~repro_torch.core.messages.TaskMessage`
(``trace={"trace_id": ..., "parent": <campaign_id>}``) and each control-plane
hop records a *span* — a named, timestamped interval attached to the task id:

    submit → route → grant → claim → run → commit
                                   ↘ revoke → (journal) → submit(attempt+1) …

Spans survive across attempts (retries, preemptions): every span carries the
``attempt`` it belongs to, so ``trace(task_id)`` returns the full linked
chain of all attempts of one logical task, and
:meth:`repro_torch.cluster.KsaCluster.campaign_report` can split a campaign's wall
time into queue vs run vs retry per stage.

The store is deliberately *lossy at the edges* — a fixed number of tasks
(LRU-evicted) and a fixed number of spans per task — so tracing a week-long
campaign cannot exhaust broker memory. Eviction counters are exposed via
:meth:`stats` so silently dropped history is visible.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque

__all__ = ["SpanStore", "NullSpanStore"]


class SpanStore:
    """Thread-safe bounded map ``task_id -> [span dict, ...]``.

    A span is a plain dict (JSON/REST friendly) with at least ``name``,
    ``task_id``, ``start``, ``end``, ``dur_s`` and ``seq`` (a store-wide
    monotonic tiebreaker for same-timestamp ordering); extra keyword
    arguments to :meth:`add` become span attributes (``attempt``,
    ``holder``, ``reason``, ...).
    """

    def __init__(self, max_tasks: int = 4096,
                 max_spans_per_task: int = 128,
                 max_recent: int = 2048) -> None:
        self.max_tasks = max_tasks
        self.max_spans_per_task = max_spans_per_task
        self._lock = threading.Lock()
        self._spans: OrderedDict = OrderedDict()
        self._seq = 0
        self.evicted_tasks = 0
        self.dropped_spans = 0
        self.enabled = True
        # side ring of recently accepted spans, in seq order — the
        # telemetry publisher drains this incrementally via since()
        # without walking the whole per-task map
        self._recent: deque = deque(maxlen=max_recent)

    def add(self, task_id: str, name: str, start: float,
            end: float | None = None, **attrs) -> None:
        if not task_id:
            return
        end = start if end is None else end
        span = {"name": name, "task_id": task_id, "start": float(start),
                "end": float(end), "dur_s": max(0.0, float(end) - float(start))}
        span.update(attrs)
        with self._lock:
            self._seq += 1
            span["seq"] = self._seq
            spans = self._spans.get(task_id)
            if spans is None:
                spans = self._spans[task_id] = []
                while len(self._spans) > self.max_tasks:
                    self._spans.popitem(last=False)
                    self.evicted_tasks += 1
            if len(spans) >= self.max_spans_per_task:
                self.dropped_spans += 1
                return
            spans.append(span)
            self._recent.append(span)

    def add_batch(self, items) -> None:
        """Batched :meth:`add`: one lock hold for N spans. ``items`` is an
        iterable of ``(task_id, span_dict)`` pairs where each span dict is
        *prebuilt* by the caller — ``name``, ``task_id``, ``start``,
        ``end``, ``dur_s`` plus any attributes; the store only stamps
        ``seq`` and takes ownership of the dicts. LRU eviction runs once
        per flush (the store may transiently exceed ``max_tasks`` by the
        batch size mid-flush). The broker's vectorized grant/claim/commit
        paths flush a whole lease batch's spans here instead of re-entering
        the lock (and rebuilding each dict) per record."""
        with self._lock:
            spans_map = self._spans
            max_spans = self.max_spans_per_task
            recent = self._recent
            seq = self._seq
            for task_id, span in items:
                if not task_id:
                    continue
                seq += 1
                span["seq"] = seq
                spans = spans_map.get(task_id)
                if spans is None:
                    spans_map[task_id] = [span]
                    recent.append(span)
                    continue
                if len(spans) >= max_spans:
                    self.dropped_spans += 1
                    continue
                spans.append(span)
                recent.append(span)
            self._seq = seq
            n_over = len(spans_map) - self.max_tasks
            if n_over > 0:
                for _ in range(n_over):
                    spans_map.popitem(last=False)
                self.evicted_tasks += n_over

    def since(self, seq: int, limit: int = 1024) -> tuple[int, list]:
        """Spans with ``seq`` greater than the watermark, oldest first,
        plus the new watermark — the telemetry publisher's incremental
        drain. Only the bounded recent ring is scanned, so a publisher
        that falls further behind than ``max_recent`` spans loses the
        oldest (the ring is the retention contract, same as the per-task
        bounds)."""
        with self._lock:
            out = [dict(s) for s in self._recent if s["seq"] > seq][:limit]
            new_seq = out[-1]["seq"] if out else max(seq, 0)
        return new_seq, out

    def trace(self, task_id: str) -> list:
        """All spans of a task (every attempt), ordered by start time then
        insertion order. Returns copies; ``[]`` for unknown tasks."""
        with self._lock:
            spans = list(self._spans.get(task_id, ()))
        return [dict(s) for s in
                sorted(spans, key=lambda s: (s["start"], s["seq"]))]

    def tasks(self) -> list:
        with self._lock:
            return list(self._spans)

    def stats(self) -> dict:
        with self._lock:
            return {"tasks": len(self._spans),
                    "spans": sum(len(v) for v in self._spans.values()),
                    "evicted_tasks": self.evicted_tasks,
                    "dropped_spans": self.dropped_spans}


class NullSpanStore:
    """Drop-in stand-in when tracing is disabled (``obs=False``)."""

    enabled = False
    evicted_tasks = 0
    dropped_spans = 0

    def add(self, task_id: str, name: str, start: float,
            end: float | None = None, **attrs) -> None:
        pass

    def add_batch(self, items) -> None:
        pass

    def since(self, seq: int, limit: int = 1024) -> tuple[int, list]:
        return max(seq, 0), []

    def trace(self, task_id: str) -> list:
        return []

    def tasks(self) -> list:
        return []

    def stats(self) -> dict:
        return {"tasks": 0, "spans": 0, "evicted_tasks": 0,
                "dropped_spans": 0}
