"""Metrics catalog generator — ``docs/METRICS.md`` from the live registry.

The catalog is generated, not hand-written: :func:`render_catalog` walks
:meth:`MetricsRegistry.describe` and emits one markdown table row per
``ksa_`` family (name, type, labels, help). ``tests/test_obs.py`` builds a
full deployment (telemetry + autoscale + pipeline + federation so every
lazily-registered family exists), renders the catalog, and fails if a
registered family is missing from the committed ``docs/METRICS.md`` — so
adding a metric without documenting it breaks the build.

Regenerate with::

    PYTHONPATH=src python -m repro_torch.obs.catalog > docs/METRICS.md
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .metrics import MetricsRegistry

__all__ = ["render_catalog", "catalog_names"]

_HEADER = """\
# Metrics catalog

All `ksa_` metric families exported on `GET /metrics` (Prometheus text
format 0.0.4). This file is generated from the live registry by
`repro_torch.obs.catalog` — do not edit rows by hand; regenerate with
`PYTHONPATH=src python -m repro_torch.obs.catalog > docs/METRICS.md`.
`tests/test_obs.py` fails if a registered family is missing here.

Histogram families additionally publish recording-rule-style series on the
telemetry plane: `{name}_count`, `{name}_sum`, and `{name}:p50/:p95/:p99`
gauges (see the `PREFIX-telemetry` record schema in
`examples/knot_campaign.py`).

| Metric | Type | Labels | Help |
|---|---|---|---|
"""


def render_catalog(registry: "MetricsRegistry") -> str:
    """Markdown catalog of every registered family, sorted by name."""
    rows = []
    for fam in registry.describe():
        labels = ", ".join(f"`{label}`" for label in fam["labels"]) or "—"
        rows.append(f"| `{fam['name']}` | {fam['type']} | {labels} "
                    f"| {fam['help']} |")
    return _HEADER + "\n".join(rows) + "\n"


def catalog_names(text: str) -> set:
    """Family names present in a rendered catalog (for the lint test)."""
    names = set()
    for line in text.splitlines():
        if line.startswith("| `ksa_"):
            names.add(line.split("`")[1])
    return names


def _full_registry() -> "MetricsRegistry":
    """Spin up one of everything so every lazily-registered family exists,
    then hand back the home registry (federation families included)."""
    from repro_torch.autoscale import AutoscaleConfig, PoolSpec
    from repro_torch.federation import FederatedCluster, Site, SpilloverConfig
    from repro_torch.pipeline import PipelineSpec, Stage
    from repro_torch.serve.metrics import register_serve_metrics

    fed = FederatedCluster(
        [Site("home", workers=1,
              autoscale=AutoscaleConfig(
                  pools=(PoolSpec("cpu", min_agents=1, max_agents=2),))),
         Site("edge", workers=1)],
        prefix="catalog", telemetry=True,
        spillover=SpilloverConfig(classes=("cpu",)))
    with fed:
        fed.wait_all([fed.submit("sleep", params={"duration": 0.01})],
                     timeout=30)
        fed.run_campaign(
            PipelineSpec("catalog", [Stage("s", "sleep",
                                           params={"duration": 0.01})]),
            items=[1], timeout_s=30)
        fed.home.autoscaler.tick()
        fed.spillover.tick()
        register_serve_metrics(fed.home.broker.metrics)
        return fed.home.broker.metrics


if __name__ == "__main__":  # pragma: no cover - generator entry point
    print(render_catalog(_full_registry()), end="")
