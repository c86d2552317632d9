"""Broker-streamed telemetry: publisher and collector for ``PREFIX-telemetry``.

The paper's thesis is that the broker is the asynchronous backbone
between components — so telemetry rides the same broker instead of a
side channel. A :class:`TelemetryPublisher` periodically snapshots the
shared :class:`~repro_torch.obs.metrics.MetricsRegistry`, drains new spans
from the :class:`~repro_torch.obs.trace.SpanStore` and new lifecycle events
from the :class:`~repro_torch.obs.blackbox.FlightRecorder`, and produces one
self-describing record per tick onto a durable ``PREFIX-telemetry``
topic (infinite retention, like the campaign journal). A
:class:`TelemetryCollector` — attached to the monitor, or run by a test
— replays that topic via the group-less ``Broker.read_from`` API and
folds the samples into a :class:`~repro_torch.obs.series.TimeSeriesStore`.

Because the topic is the source of truth, the plane is loss-tolerant by
construction: killing the collector (the monitor) loses nothing — a
restarted collector replays from offset 0 and rebuilds the exact same
store. And because a collector can hold *feeds* into several brokers,
the federation home folds every remote site's telemetry into one store
whose series carry a ``site`` label, so ``sum_by("site")`` queries are
answered at home with no merge protocol.

Telemetry record schema (topic ``PREFIX-telemetry``, keyed by source)::

    {"kind": "telemetry", "v": 1,
     "source": "<publisher id>",         # e.g. "cluster" / site name
     "site":   "<site name or ''>",
     "seq":    <per-publisher counter>,
     "ts":     <float unix time>,
     "metrics": [{"name", "type", "labels", "value"}          # counter/gauge
                 | {"name", "type": "histogram", "labels",
                    "count", "sum", "p50", "p95", "p99"}],
     "spans":  [<span dict>, ...],       # new since last tick
     "events": [<blackbox event>, ...]}  # new since last tick

Histogram samples fold into recording-rule-style series:
``{name}_count`` / ``{name}_sum`` (counters) and ``{name}:p50`` /
``:p95`` / ``:p99`` (gauges) — e.g. an SLO on queue-wait p95 targets
``ksa_task_queue_wait_seconds:p95``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable

from .series import TimeSeriesStore

__all__ = ["TelemetryPublisher", "TelemetryCollector"]

log = logging.getLogger("repro_torch.obs.telemetry")

_QUANTS = ("p50", "p95", "p99")


class TelemetryPublisher:
    """Periodically emits metric/span/event snapshots as broker records.

    One publisher per cluster (it snapshots the broker-owned registry
    that every co-located component — agents, monitor, pipeline,
    autoscaler — already writes into, so "a publisher on every
    component" costs one thread, not N). Extra per-component sample
    callables can be attached with :meth:`add_source`.
    """

    def __init__(self, broker: Any, topic: str, *, source: str = "cluster",
                 site: str = "", interval_s: float = 0.5,
                 recorder: Any | None = None) -> None:
        self.broker = broker
        self.topic = topic
        self.source = source
        self.site = site or getattr(broker, "site", "") or ""
        self.interval_s = float(interval_s)
        self.recorder = recorder if recorder is not None else getattr(
            broker, "blackbox", None)
        self._sources: list[Callable[[], list]] = []
        self._span_seq = 0
        self._event_seq = 0
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._c_pub = broker.metrics.counter(
            "ksa_telemetry_publishes_total",
            "Telemetry records produced onto the telemetry topic.",
            ["source"]).labels(source=source)
        # telemetry must survive component death: pin infinite retention
        # (same contract as the campaign journal topic)
        broker.create_topic(topic, retention_records=None)

    def add_source(self, fn: Callable[[], list]) -> None:
        """Attach a callable returning extra sample dicts (same shape as
        ``MetricsRegistry.sample()`` rows), merged into every tick."""
        self._sources.append(fn)

    def publish_once(self) -> Any | None:
        """Snapshot + produce one telemetry record (None if closed).

        Public so tests and examples can drive the plane
        deterministically instead of sleeping through intervals.
        """
        try:
            samples = self.broker.metrics.sample()
            for fn in self._sources:
                try:
                    samples.extend(fn() or [])
                except Exception:  # noqa: BLE001 — a bad source must not
                    pass           # starve the rest of the snapshot
            self._span_seq, spans = self.broker.spans.since(self._span_seq)
            events: list = []
            if self.recorder is not None:
                self._event_seq, events = self.recorder.since(
                    self._event_seq)
            self._seq += 1
            value = {"kind": "telemetry", "v": 1, "source": self.source,
                     "site": self.site, "seq": self._seq,
                     "ts": time.time(), "metrics": samples,
                     "spans": spans, "events": events}
            rec = self.broker.produce(self.topic, value, key=self.source)
            self._c_pub.inc()
            return rec
        except Exception:  # noqa: BLE001 — broker closing mid-publish
            log.debug("telemetry publish failed", exc_info=True)
            return None

    # ------------------------------------------------------------ thread

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"telemetry-pub-{self.source}",
            daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.publish_once()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=timeout)
            self._thread = None
        # final flush so short-lived runs still land one snapshot
        self.publish_once()


class _Feed:
    """One broker/topic to drain: per-partition replay watermarks."""

    __slots__ = ("broker", "topic", "site", "local", "offsets")

    def __init__(self, broker: Any, topic: str, site: str,
                 local: bool) -> None:
        self.broker = broker
        self.topic = topic
        self.site = site
        self.local = local
        self.offsets: dict[int, int] = {}


class TelemetryCollector:
    """Folds telemetry records from one or more brokers into a store.

    The default feed is the collector's own broker. The federation home
    adds one feed per remote site (:meth:`add_feed`), which is how
    site-labelled series from every site end up in one queryable store.
    Spans and blackbox events from *remote* feeds are folded into the
    local span store / flight recorder (stamped with the site), so the
    home pane also answers traces and post-mortems across the WAN;
    local-feed spans/events are skipped — they are already in the local
    stores, folding them back would double-count.
    """

    def __init__(self, broker: Any, topic: str, *,
                 store: TimeSeriesStore | None = None, site: str = "",
                 recorder: Any | None = None) -> None:
        self.broker = broker
        self.topic = topic
        self.site = site or getattr(broker, "site", "") or ""
        self.store = store if store is not None else TimeSeriesStore()
        self.recorder = recorder if recorder is not None else getattr(
            broker, "blackbox", None)
        self._lock = threading.Lock()
        self._feeds: list[_Feed] = [_Feed(broker, topic, self.site,
                                          local=True)]
        self._c_recs = broker.metrics.counter(
            "ksa_telemetry_records_total",
            "Telemetry records folded into the time-series store.",
            ["site"])
        broker.create_topic(topic, retention_records=None)

    def add_feed(self, broker: Any, topic: str, site: str) -> None:
        """Drain another broker's telemetry topic (federation home)."""
        with self._lock:
            self._feeds.append(_Feed(broker, topic, site, local=False))

    def poll(self) -> int:
        """Drain every feed from its watermark; returns records folded."""
        with self._lock:
            feeds = list(self._feeds)
        folded = 0
        for feed in feeds:
            try:
                nparts = feed.broker.partitions_for(feed.topic)
            except Exception:  # noqa: BLE001 — remote broker gone/closed
                continue
            for p in range(nparts):
                off = feed.offsets.get(p, 0)
                try:
                    recs = feed.broker.read_from(feed.topic, off,
                                                 partition=p)
                except Exception:  # noqa: BLE001
                    continue
                for rec in recs:
                    val = rec.value
                    if isinstance(val, dict) and val.get(
                            "kind") == "telemetry":
                        self._fold(val, feed)
                        folded += 1
                    feed.offsets[p] = rec.offset + 1
        return folded

    def _fold(self, rec: dict, feed: _Feed) -> None:
        site = rec.get("site") or feed.site or ""
        ts = float(rec.get("ts") or time.time())
        samples = []
        for m in rec.get("metrics", ()):
            name = m.get("name")
            if not name:
                continue
            labels = dict(m.get("labels") or {})
            if site:
                labels["site"] = site
            mtype = m.get("type", "gauge")
            if mtype == "histogram":
                samples.append((f"{name}_count", labels, ts,
                                m.get("count", 0), "counter"))
                samples.append((f"{name}_sum", labels, ts,
                                m.get("sum", 0.0), "counter"))
                for qn in _QUANTS:
                    qv = m.get(qn)
                    if qv is not None:
                        samples.append((f"{name}:{qn}", labels, ts, qv,
                                        "gauge"))
            else:
                samples.append((name, labels, ts, m.get("value", 0.0),
                                mtype))
        if samples:
            self.store.ingest_many(samples)
        if not feed.local:
            spans = rec.get("spans") or ()
            if spans:
                self.broker.spans.add_batch(
                    [(s.get("task_id"), dict(s, site=site))
                     for s in spans])
            if self.recorder is not None:
                for ev in rec.get("events", ()):
                    attrs = {k: v for k, v in ev.items()
                             if k not in ("kind", "seq")}
                    attrs["site"] = site
                    self.recorder.record(ev.get("kind", "event"), **attrs)
        self._c_recs.labels(site=site or "local").inc()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            feeds = [{"site": f.site or "local", "local": f.local,
                      "offsets": dict(f.offsets)} for f in self._feeds]
        return {"feeds": feeds, "store": self.store.stats()}
