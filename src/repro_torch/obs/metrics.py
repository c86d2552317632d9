"""In-process metrics registry for the KSA control plane.

The paper's monitor agent answers "how many tasks are done?"; operating the
control plane at proteome scale additionally needs "where does the
time go *per task*" — queue wait vs claim latency vs run time vs commit
latency, broken down by resource class. This module is the substrate: a
single :class:`MetricsRegistry` that every subsystem (broker, lease table,
agents, monitor, pipeline agent, autoscale controller) registers counters,
gauges and histograms into, rendered on demand as Prometheus text exposition
(``GET /metrics`` on the monitor).

Design constraints, in order:

1. **Counters and gauges are always live**, even with observability disabled
   — the legacy ``stats()`` / ``status()`` / ``/summary`` dictionaries are
   now *views* over registry values, so zeroing them would break the control
   plane's own bookkeeping. Only histograms (and trace spans, see
   :mod:`repro_torch.obs.trace`) honour the ``enabled`` switch, because they are
   the part with a per-observation cost.
2. **Low overhead**: one short lock hold per observation, no allocation on
   the counter hot path, a bounded sample ring per histogram child for exact
   p50/p95/p99 (Prometheus buckets alone only bound quantiles).
3. **Prometheus conventions**: metric families carry a fixed label-name
   tuple; ``labels(**kv)`` interns a child per label-value combination;
   ``render()`` emits ``# HELP`` / ``# TYPE`` plus cumulative ``_bucket``
   lines with an ``+Inf`` terminator for histograms.

Naming/label conventions used across the repo (documented for scrapers):

- every metric is prefixed ``ksa_`` and timed metrics end in ``_seconds``;
- per-resource-class latencies carry a ``cls`` label whose value is the
  suffix of the class topic (``PREFIX-new.gpu`` → ``gpu``; the flat
  single-topic layout reports ``flat``) — see :func:`topic_class`;
- lifecycle event counters are one family with an ``event`` label
  (``ksa_agent_events_total{agent=...,event=...}``) rather than one family
  per event, mirroring the revocation counter's ``reason`` label.
"""
from __future__ import annotations

import bisect
import functools
import threading
from collections import deque
from typing import Callable, Iterable, Mapping, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "inject_label",
    "merge_renders",
    "topic_class",
]

# Spans the range of latencies the control plane actually exhibits: sub-ms
# broker ops through multi-minute campaign stages.
DEFAULT_BUCKETS: tuple = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)

# Exact-quantile sample ring size per histogram child. 512 recent samples
# give stable p50/p95 and a usable p99 while bounding memory.
_SAMPLE_RING = 512


@functools.lru_cache(maxsize=4096)
def topic_class(topic: str) -> str:
    """Resource-class label for a task topic.

    Per-class topics are ``PREFIX-new.<cls>`` (see
    :func:`repro_torch.core.scheduling.class_topic`); the paper's flat layout uses
    the bare ``PREFIX-new``, which we label ``"flat"``.

    Cached per topic name: the broker grant path and the queue-stat/metric
    label sites call this per record, and a deployment has a handful of
    distinct topics — the parse should run once per topic, not once per
    task (the cache bound only matters for pathological topic churn).
    """
    base, sep, cls = topic.rpartition("-new.")
    if sep and base and cls:
        return cls
    return "flat"


class Counter:
    """A monotonically increasing integer. Starts at ``0`` (an ``int``), so
    legacy ``stats()`` views built on top keep their integer arithmetic."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, amount: int = 1) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """A value that can go up and down."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram plus a bounded ring of recent raw samples
    for exact quantiles (:meth:`quantile` / :meth:`percentiles`)."""

    __slots__ = ("_lock", "_uppers", "_counts", "_sum", "_count", "_ring")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self._lock = threading.Lock()
        self._uppers = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self._uppers) + 1)  # +1 = +Inf
        self._sum = 0.0
        self._count = 0
        self._ring: deque = deque(maxlen=_SAMPLE_RING)

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._counts[bisect.bisect_left(self._uppers, v)] += 1
            self._sum += v
            self._count += 1
            self._ring.append(v)

    def observe_many(self, values: Sequence[float]) -> None:
        """Batched observe: one lock hold for N samples. The broker's
        vectorized grant path records a whole lease batch's queue waits
        here instead of re-entering the lock per record."""
        if not values:
            return
        vs = [float(v) for v in values]
        with self._lock:
            counts, uppers = self._counts, self._uppers
            total = 0.0
            for v in vs:
                counts[bisect.bisect_left(uppers, v)] += 1
                total += v
            self._sum += total
            self._count += len(vs)
            self._ring.extend(vs)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float | None:
        """Exact quantile over the sample ring; ``None`` when empty."""
        with self._lock:
            samples = sorted(self._ring)
        if not samples:
            return None
        idx = min(len(samples) - 1, max(0, round(q * (len(samples) - 1))))
        return samples[idx]

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50),
                "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}

    def snapshot(self) -> dict:
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
            return {"buckets": dict(zip(self._uppers, cum)),
                    "inf": cum[-1] if cum else 0,
                    "sum": self._sum, "count": self._count}


class _NullHistogram:
    """Histogram stand-in when observability is disabled: observations are
    dropped, reads report empty."""

    __slots__ = ()

    def observe(self, value: float) -> None:
        pass

    def observe_many(self, values: Sequence[float]) -> None:
        pass

    count = 0
    sum = 0.0

    def quantile(self, q: float) -> None:
        return None

    def percentiles(self) -> dict:
        return {"p50": None, "p95": None, "p99": None}

    def snapshot(self) -> dict:
        return {"buckets": {}, "inf": 0, "sum": 0.0, "count": 0}


class Family:
    """A named metric family: fixed label names, one child per label-value
    combination. Label-less families proxy ``inc``/``set``/``observe`` to a
    single default child for convenience."""

    def __init__(self, name: str, help_: str, label_names: tuple,
                 make_child: Callable[[], object]) -> None:
        self.name = name
        self.help = help_
        self.label_names = label_names
        self._make_child = make_child
        self._lock = threading.Lock()
        self._children: dict = {}
        if not label_names:
            self._children[()] = make_child()

    def labels(self, **kv: str) -> object:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got "
                f"{tuple(sorted(kv))}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def items(self) -> Iterable:
        with self._lock:
            return list(self._children.items())

    # -- label-less convenience ------------------------------------------
    def _default(self) -> object:
        return self._children[()]

    def inc(self, amount=1) -> None:
        self._default().inc(amount)

    def dec(self, amount=1) -> None:
        self._default().dec(amount)

    def set(self, value) -> None:
        self._default().set(value)

    def observe(self, value) -> None:
        self._default().observe(value)

    def observe_many(self, values) -> None:
        self._default().observe_many(values)

    @property
    def value(self):
        return self._default().value

    @property
    def count(self):
        return self._default().count

    @property
    def sum(self):
        return self._default().sum

    def quantile(self, q: float):
        return self._default().quantile(q)

    def percentiles(self) -> dict:
        return self._default().percentiles()


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _esc(v) -> str:
    """Escape a label value per the exposition format: backslash, quote
    and newline are the three characters the spec requires escaping."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _series(name: str, label_names: tuple, label_values: tuple,
            value, suffix: str = "", extra: Mapping | None = None) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(label_names, label_values)]
    if extra:
        pairs += [f'{n}="{_esc(v)}"' for n, v in extra.items()]
    labels = ("{" + ",".join(pairs) + "}") if pairs else ""
    return f"{name}{suffix}{labels} {_fmt(value)}"


def inject_label(text: str, **labels: str) -> str:
    """Rewrite a Prometheus exposition so every sample line carries the
    given label(s) — the federation aggregator's tool for merging N
    per-site registries into one ``/metrics`` page with a ``site`` label
    (the Prometheus federation convention). ``# HELP`` / ``# TYPE`` lines
    and blanks pass through untouched; existing labels are preserved and
    the injected pairs are appended (or prepended into ``name value``
    lines). Injected values are escaped per the exposition format."""
    pairs = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
    if not pairs:
        return text
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        # sample lines are `name{labels} value` or `name value`
        head, _, value = line.rpartition(" ")
        if not head:
            out.append(line)
            continue
        if head.endswith("}"):
            base = head[:-1]
            sep = "" if base.endswith("{") else ","
            out.append(f"{base}{sep}{pairs}}} {value}")
        else:
            out.append(f"{head}{{{pairs}}} {value}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def merge_renders(renders: Mapping[str, str], label: str = "site") -> str:
    """Concatenate per-site :meth:`MetricsRegistry.render` outputs into one
    exposition: every sample gains ``{label}="<site>"`` and duplicate
    ``# HELP`` / ``# TYPE`` headers (the same family exists on every site)
    are emitted once, on first sight."""
    lines: list = []
    seen_meta: set = set()
    for site, text in renders.items():
        tagged = inject_label(text, **{label: site})
        for ln in tagged.splitlines():
            if ln.startswith("#"):
                if ln in seen_meta:
                    continue
                seen_meta.add(ln)
            lines.append(ln)
    return "\n".join(lines) + "\n"


class MetricsRegistry:
    """Process-wide (well, broker-wide) metric store.

    ``enabled=False`` keeps counters and gauges fully functional — the
    legacy stats views depend on them — but replaces histograms with no-op
    nulls so the per-observation cost disappears (benchmarked in
    ``benchmarks/bench_obs.py``).
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: dict = {}
        self._types: dict = {}
        self._callbacks: dict = {}

    # -- family constructors ---------------------------------------------
    def _family(self, name: str, help_: str, labels: tuple, type_: str,
                make_child: Callable[[], object]) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if self._types[name] != type_ or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} re-registered as {type_}{labels}, "
                        f"was {self._types[name]}{fam.label_names}")
                return fam
            fam = Family(name, help_, labels, make_child)
            self._families[name] = fam
            self._types[name] = type_
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._family(name, help_, tuple(labels), "counter", Counter)

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._family(name, help_, tuple(labels), "gauge", Gauge)

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Family:
        if not self.enabled:
            return self._family(name, help_, tuple(labels), "histogram",
                                _NullHistogram)
        return self._family(name, help_, tuple(labels), "histogram",
                            lambda: Histogram(buckets))

    def register_callback(self, name: str, fn: Callable[[], float],
                          help_: str = "") -> None:
        """A gauge whose value is computed at render time (e.g. live lease
        count straight from the lease table)."""
        with self._lock:
            self._callbacks[name] = (help_, fn)

    # -- export ----------------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list = []
        with self._lock:
            families = list(self._families.items())
            callbacks = list(self._callbacks.items())
        for name, fam in sorted(families):
            type_ = self._types[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {type_}")
            for key, child in sorted(fam.items()):
                if type_ in ("counter", "gauge"):
                    lines.append(_series(name, fam.label_names, key,
                                         child.value))
                    continue
                snap = child.snapshot()
                for upper, cum in snap["buckets"].items():
                    lines.append(_series(name, fam.label_names, key, cum,
                                         "_bucket", {"le": _fmt(upper)}))
                lines.append(_series(name, fam.label_names, key,
                                     snap["inf"], "_bucket", {"le": "+Inf"}))
                lines.append(_series(name, fam.label_names, key,
                                     snap["sum"], "_sum"))
                lines.append(_series(name, fam.label_names, key,
                                     snap["count"], "_count"))
        for name, (help_, fn) in sorted(callbacks):
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
            try:
                value = float(fn())
            except Exception:
                continue
            lines.append(_series(name, (), (), value))
        return "\n".join(lines) + "\n"

    def describe(self) -> list:
        """Registered family descriptors — ``{name, type, labels, help}``
        rows (callback gauges included). Feeds the ``docs/METRICS.md``
        catalog generator and its lint test."""
        with self._lock:
            families = list(self._families.items())
            callbacks = list(self._callbacks.items())
        rows = [{"name": name, "type": self._types[name],
                 "labels": list(fam.label_names), "help": fam.help}
                for name, fam in families]
        rows += [{"name": name, "type": "gauge", "labels": [],
                  "help": help_} for name, (help_, fn) in callbacks]
        return sorted(rows, key=lambda r: r["name"])

    def sample(self) -> list:
        """Flat telemetry samples, one dict per live child series — the
        :class:`~repro_torch.obs.telemetry.TelemetryPublisher` payload. Counters
        and gauges carry ``value``; histograms are pre-digested into
        ``count``/``sum`` plus ring quantiles (p50/p95/p99), which is what
        the time-series store folds into recording-rule-style series."""
        out: list = []
        with self._lock:
            families = list(self._families.items())
            callbacks = list(self._callbacks.items())
        for name, fam in families:
            type_ = self._types[name]
            for key, child in fam.items():
                labels = dict(zip(fam.label_names, key))
                if type_ in ("counter", "gauge"):
                    out.append({"name": name, "type": type_,
                                "labels": labels, "value": child.value})
                else:
                    snap = child.snapshot()
                    pct = child.percentiles()
                    out.append({"name": name, "type": "histogram",
                                "labels": labels, "count": snap["count"],
                                "sum": snap["sum"], "p50": pct["p50"],
                                "p95": pct["p95"], "p99": pct["p99"]})
        for name, (help_, fn) in callbacks:
            try:
                value = float(fn())
            except Exception:
                continue
            out.append({"name": name, "type": "gauge", "labels": {},
                        "value": value})
        return out

    def snapshot(self) -> dict:
        """Programmatic dump (tests): ``{name: {labels_tuple: value}}`` with
        histogram children rendered as their snapshot dict."""
        out: dict = {}
        with self._lock:
            families = list(self._families.items())
        for name, fam in families:
            type_ = self._types[name]
            series = {}
            for key, child in fam.items():
                series[key] = (child.value if type_ in ("counter", "gauge")
                               else child.snapshot())
            out[name] = {"type": type_, "series": series}
        return out
