"""Serve metric families on the shared ``repro_torch.obs`` registry.

Registration is idempotent (``MetricsRegistry`` returns the existing family
on re-registration), so every engine/replica in a process shares one set of
families and distinguishes itself with the ``replica`` label. The catalog
generator (``repro_torch.obs.catalog._full_registry``) calls
:func:`register_serve_metrics` directly so these families appear in
``docs/METRICS.md`` and pass the catalog lint without spinning up a model.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["register_serve_metrics"]

# sub-second-heavy buckets: queue waits and TTFT under load sit in the
# 1ms..10s range; decode steps in the 100us..1s range.
_LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def register_serve_metrics(registry: "MetricsRegistry") -> dict:
    """Create (or fetch) the serving-tier families; returns them keyed by
    short name for the engine/replica-set hot paths."""
    return {
        "queue_wait": registry.histogram(
            "ksa_serve_queue_wait_seconds",
            "Request arrival to slot admission wait.",
            labels=("replica",), buckets=_LATENCY_BUCKETS),
        "ttft": registry.histogram(
            "ksa_serve_ttft_seconds",
            "Request arrival to first generated token.",
            labels=("replica",), buckets=_LATENCY_BUCKETS),
        "step": registry.histogram(
            "ksa_serve_step_seconds",
            "One continuous-batching decode step (device call).",
            labels=("replica",), buckets=_LATENCY_BUCKETS),
        "tokens": registry.counter(
            "ksa_serve_tokens_total",
            "Tokens generated by the serving engine.",
            labels=("replica",)),
        "requests": registry.counter(
            "ksa_serve_requests_total",
            "Request lifecycle events "
            "(admitted/completed/evicted/shed/spilled).",
            labels=("replica", "event")),
        "slots_active": registry.gauge(
            "ksa_serve_slots_active",
            "Continuous-batching slots currently generating.",
            labels=("replica",)),
        "slots_total": registry.gauge(
            "ksa_serve_slots_total",
            "Continuous-batching slot capacity.",
            labels=("replica",)),
        "pages_used": registry.gauge(
            "ksa_serve_pages_used",
            "KV-cache pages currently bound to slots.",
            labels=("replica",)),
        "pages_total": registry.gauge(
            "ksa_serve_pages_total",
            "Usable KV-cache page capacity.",
            labels=("replica",)),
    }
