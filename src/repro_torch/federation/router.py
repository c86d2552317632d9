"""SiteRouter — placement across federation sites.

Extends the single-site :class:`~repro_torch.core.scheduling.ResourceClassPolicy`
with one new routing dimension: **which site**. Each remote site gets a
dedicated resource class ``site.<name>`` (and therefore a dedicated class
topic ``PREFIX-new.site.<name>`` on the home broker) that only that site's
bridge subscribes to — site affinity reuses the same taint-exclusive
mechanism that keeps a serve pool from draining batch work, so nothing in
the agents or the broker needs to know about federation for pinning to
work.

Three placement behaviours compose:

* **affinity** — ``Resources(site="b")`` routes to ``site.b`` regardless of
  cpu/gpu class; the site's bridge relays it. Campaign stages pin the same
  way (``Stage(resources=Resources(site=...))``).
* **data locality** — :meth:`spill_score` charges a candidate site for the
  task's ``input_mb`` over its link (latency + size/bandwidth, both ways
  for the result) so a data-heavy task prefers the site holding its input.
* **cost-aware spillover** — unpinned tasks route to their normal cpu/gpu
  class; when the home backlog outruns its drain rate the
  :class:`~repro_torch.federation.SpilloverController` raises *spill bridges*
  that join the same consumer group on those class topics, and
  :meth:`spill_score` ranks which remote site the overflow should drain
  to (cold-start vs slot-seconds vs transfer).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Iterable

from repro_torch.core.scheduling import (PlacementPolicy, ResourceClassPolicy,
                                   ResourceProfile, class_topic)

from .site import Site

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.messages import TaskMessage

__all__ = ["SiteRouter", "site_class"]

_SITE_PREFIX = "site."


def site_class(name: str) -> str:
    """The resource class a remote site's pinned work routes to."""
    return f"{_SITE_PREFIX}{name}"


class SiteRouter(PlacementPolicy):
    """Site-aware placement for a :class:`~repro_torch.federation.FederatedCluster`.

    Wraps a :class:`ResourceClassPolicy` whose extra classes include one
    ``site.<name>`` class per remote site. A task with ``resources.site``
    set to a remote site classifies into that site class; everything else
    (including ``site`` equal to the home site, the explicit "keep it
    local" pin) falls through to the normal cpu/gpu/label classification.
    Subscriptions delegate unchanged, so ordinary pools never see the site
    classes and bridges opt in via taint-exclusive profiles."""

    def __init__(self, sites: Iterable[str], *, home: str,
                 extra_classes: tuple[str, ...] = (),
                 gpu_takes_cpu: bool = True):
        self.home = home
        self.site_names = tuple(sites)
        if home not in self.site_names:
            raise ValueError(
                f"home site {home!r} is not among sites "
                f"{list(self.site_names)}")
        self._remote = tuple(s for s in self.site_names if s != home)
        self._inner = ResourceClassPolicy(
            extra_classes=tuple(extra_classes)
            + tuple(site_class(s) for s in self._remote),
            gpu_takes_cpu=gpu_takes_cpu)

    # -- PlacementPolicy -------------------------------------------------

    def classes(self) -> tuple[str, ...]:
        return self._inner.classes()

    def classify(self, task: "TaskMessage") -> str:
        pin = getattr(task.resources, "site", "")
        if pin and pin != self.home:
            if pin not in self.site_names:
                raise ValueError(
                    f"task {task.task_id}: pinned to unknown site {pin!r} "
                    f"(federation sites: {list(self.site_names)})")
            return site_class(pin)
        return self._inner.classify(task)

    def topics(self, prefix: str) -> tuple[str, ...]:
        return self._inner.topics(prefix)

    def route(self, prefix: str, task: "TaskMessage") -> str:
        return class_topic(prefix, self.classify(task))

    def subscriptions(self, prefix: str,
                      profile: ResourceProfile | None) -> tuple[str, ...]:
        return self._inner.subscriptions(prefix, profile)

    # -- bridge profiles -------------------------------------------------

    def affinity_profile(self, site_name: str) -> ResourceProfile:
        """The taint-exclusive profile an affinity bridge runs with: it
        subscribes *only* to ``PREFIX-new.site.<name>``, so pinned work is
        the only work it ever leases — and no other pool ever drains the
        site class, because no other profile carries the taint."""
        cls = site_class(site_name)
        return ResourceProfile(labels=(cls,), taints=(cls,))

    # -- cost model ------------------------------------------------------

    def spill_score(self, site: Site, task: "TaskMessage" = None, *,
                    est_run_s: float = 1.0) -> float:
        """Cost (modeled seconds) of running one task at ``site`` instead
        of home: cold-start + priced slot-seconds + WAN transfer of the
        task's input there and its (weightless) result back. Lower is
        better; the spillover controller picks the argmin across remote
        sites. A partitioned link is unreachable — ``inf``."""
        if not site.link.up:
            return float("inf")
        input_mb = 0.0
        if task is not None:
            input_mb = float(getattr(task.resources, "input_mb", 0.0) or 0.0)
        transfer = site.link.one_way_s(input_mb) + site.link.one_way_s()
        return site.spinup_s + site.slot_cost * est_run_s + transfer
