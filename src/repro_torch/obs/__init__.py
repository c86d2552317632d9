"""repro_torch.obs — observability substrate + telemetry plane for KSA.

In-process substrate:

- :class:`MetricsRegistry` — counters / gauges / histograms (with exact
  p50/p95/p99 over a bounded sample ring) that the broker, lease table,
  agents, monitor, pipeline agent and autoscale controller all register
  into. Rendered as Prometheus text by the monitor's ``GET /metrics``.
- :class:`SpanStore` — a bounded in-memory per-task span store on the
  broker; the trace context rides in ``TaskMessage.trace`` and every
  control-plane hop (submit → route → grant → claim → run → commit /
  revoke → journal) records a span, linked across attempts. Surfaced via
  ``GET /trace/<task_id>`` and :meth:`repro_torch.cluster.KsaCluster.trace` /
  ``campaign_report``.
- :func:`sample_rss_mb` — kernel-accounted process RSS for the agents'
  memory watchdog (self-reporting via ``report_mem`` stays as an
  override).

Telemetry plane — streamed over the broker itself:

- :class:`TelemetryPublisher` / :class:`TelemetryCollector` — periodic
  metric/span/event snapshots as durable records on ``PREFIX-telemetry``,
  replayed (``Broker.read_from``) into a…
- :class:`TimeSeriesStore` — bounded per-series rings with aligned
  windows and ``rate()`` / ``quantile()`` / ``sum_by(label)`` queries,
  served on ``GET /query`` and ``KsaCluster.query(...)``; federation
  feeds merge site-labelled series at the home store.
- :class:`SloSpec` / :class:`AlertRule` / :class:`AlertEngine` —
  multi-window burn-rate alerting over the store (``GET /alerts``,
  ``status()["alerts"]``, ``ksa_alerts_total{rule,state}``).
- :class:`FlightRecorder` — an always-on bounded blackbox of lifecycle
  events (grants, revocations with reasons, drains, spills, journal
  repairs) that auto-dumps a post-mortem on revocation storms, campaign
  FAILED or alert firing (``GET /blackbox``,
  ``KsaCluster.dump_blackbox()``).

The in-process layer stays switchable: ``KsaCluster(obs=False)`` nulls
histograms and spans while keeping counters/gauges live. The telemetry
plane is opt-in (``KsaCluster(telemetry=True)``) and budgeted at ≤10%
end-to-end overhead on a no-op DAG (``benchmarks/bench_obs.py`` →
``BENCH_obs.json``).

Step spans — :func:`span`, profiler ranges inside the model code, which
record nothing unless ``torch.profiler`` runs around them:

- ``repro.train_step``: one train step; inside it ``repro.forward`` (the
  model and the loss), ``repro.backward`` (everything ``autograd.grad``
  launches, remat's recomputation included; on CUDA it is opened again on
  the autograd engine's device thread, which runs the backward's kernels)
  and ``repro.optimizer`` (learning rate, clipping, AdamW, the step count);
- ``repro.encode``: one encoder call (``make_prefill_step``);
- ``repro.mixer`` and ``repro.ffn``: each block's norm, mixing layer and
  residual add, and its second norm, MLP or MoE and add;
- ``repro.kernel.ssd_scan``, ``repro.kernel.ssd_scan_bwd``,
  ``repro.kernel.flash_attention``, ``repro.kernel.flash_attention_bwd``:
  the hand kernels' launches.

To see them, profile a few steps and open the trace in Perfetto or
``chrome://tracing``::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace("steps.json")

A kernel launched inside a range is linked to it by the profiler's
correlation id, so the device time under each range can be summed.
"""
from .blackbox import FlightRecorder
from .metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                      MetricsRegistry, inject_label, merge_renders,
                      topic_class)
from .rss import sample_rss_mb
from .series import TimeSeriesStore
from .slo import AlertEngine, AlertRule, SloSpec
from .telemetry import TelemetryCollector, TelemetryPublisher
from .trace import NullSpanStore, SpanStore, span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "inject_label",
    "merge_renders",
    "topic_class",
    "SpanStore",
    "NullSpanStore",
    "span",
    "sample_rss_mb",
    "TimeSeriesStore",
    "TelemetryPublisher",
    "TelemetryCollector",
    "SloSpec",
    "AlertRule",
    "AlertEngine",
    "FlightRecorder",
]
