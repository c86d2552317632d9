"""FederatedCluster — N KSA deployments behind the single-cluster API.

The paper's deployment already spans "multiple Slurm-managed HPC clusters
and workstations", but as one flat consumer group on one broker — every
agent polls every topic, and there is no notion of *where* a task should
run or what moving it there costs. ``FederatedCluster`` keeps each site a
full, independent control plane (its own :class:`~repro_torch.core.broker.Broker`,
pools, monitor, autoscaler) and federates them at the control level::

    from repro_torch.federation import FederatedCluster, Site, WanLink

    with FederatedCluster([
        Site("edge", workers=2),                       # home: submissions enter here
        Site("hpc", workers=4, spinup_s=2.0,
             link=WanLink(latency_s=0.05, bandwidth_mbps=200.0)),
    ], spillover=SpilloverConfig(horizon_s=3.0)) as fed:
        tid = fed.submit("knot_scan", params=...)              # runs anywhere
        pinned = fed.submit("knot_scan", site="hpc", ...)      # site affinity
        fed.wait_all([tid, pinned])

The first site is **home**: its broker holds the authoritative lease for
every task, its monitor serves the federated REST API (``/sites``, the
site-labelled ``/metrics``), and its class topics are where all work
lands. Remote sites receive work only through
:class:`~repro_torch.federation.bridge.SiteBridgeAgent` relays — *affinity*
bridges (always on, draining each site's ``site.<name>`` pin class) and
*spill* bridges (raised by the :class:`~repro_torch.federation.
SpilloverController` when home backlog outruns its drain rate). Because a
bridge is just another home consumer holding a home lease, the federation
inherits the single-site exactly-once story wholesale: cross-site
revocation fences through the same :meth:`~repro_torch.core.broker.Broker.
complete_lease` gate, and WAN slowness is absorbed by per-site lease
deadlines (:class:`~repro_torch.core.lease.LeaseTolerance`) instead of weakening
the watchdog everywhere.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Mapping, Sequence

from repro_torch.cluster import KsaCluster
from repro_torch.core.lease import RevokeReason
from repro_torch.core.messages import Resources, topic_names
from repro_torch.core.scheduling import ResourceProfile
from repro_torch.obs import merge_renders

from .bridge import SiteBridgeAgent
from .router import SiteRouter
from .site import Site
from .spillover import SpilloverConfig, SpilloverController

__all__ = ["FederatedCluster"]


class FederatedCluster:
    """Context-managed multi-site deployment, API-compatible with
    :class:`~repro_torch.cluster.KsaCluster` for the task/campaign surface.

    ``sites[0]`` is the home site. Remote clusters run under prefix
    ``{prefix}-{site}`` on their own brokers; ``Site.cluster_kw`` passes
    extra :class:`KsaCluster` kwargs per site (e.g. a site-local
    ``autoscale`` config rides in ``Site.autoscale``). ``bridge_slots``
    bounds each affinity bridge's in-flight relays."""

    def __init__(self, sites: Sequence[Site], *, prefix: str = "ksa",
                 spillover: SpilloverConfig | None = None,
                 http: bool = False,
                 bridge_slots: int = 4,
                 remote_poll_s: float = 0.02,
                 task_timeout_s: float | None = None,
                 max_attempts: int = 3,
                 poll_interval_s: float = 0.01,
                 extra_classes: tuple[str, ...] = (),
                 gpu_takes_cpu: bool = True,
                 telemetry: bool = False,
                 telemetry_interval_s: float = 0.25,
                 slos: Sequence[Any] = ()):
        self.sites = tuple(sites)
        if not self.sites:
            raise ValueError("a federation needs at least one site")
        names = [s.name for s in self.sites]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate site names: {names}")
        self.prefix = prefix
        self.task_timeout_s = task_timeout_s
        self.bridge_slots = bridge_slots
        self.remote_poll_s = remote_poll_s
        self.poll_interval_s = poll_interval_s
        self.home_site = self.sites[0]
        self.remote_sites = self.sites[1:]
        self.router = SiteRouter(names, home=self.home_site.name,
                                 extra_classes=extra_classes,
                                 gpu_takes_cpu=gpu_takes_cpu)
        self._telemetry_enabled = telemetry
        self.home = self._build_cluster(
            self.home_site, prefix=prefix, placement=self.router,
            http=http, task_timeout_s=task_timeout_s,
            max_attempts=max_attempts, telemetry=telemetry,
            telemetry_interval_s=telemetry_interval_s, slos=tuple(slos))
        self.clusters: dict[str, KsaCluster] = {self.home_site.name: self.home}
        for s in self.remote_sites:
            self.clusters[s.name] = self._build_cluster(
                s, prefix=f"{prefix}-{s.name}", placement=None,
                http=False, task_timeout_s=task_timeout_s,
                max_attempts=max_attempts, telemetry=telemetry,
                telemetry_interval_s=telemetry_interval_s)
        self._spill_cfg = spillover
        self.spillover: SpilloverController | None = None
        self._bridges: list[SiteBridgeAgent] = []
        self._lock = threading.RLock()
        self._started = False
        self._stopped = False

    def _build_cluster(self, site: Site, **kw: Any) -> KsaCluster:
        merged: dict[str, Any] = dict(
            site=site.name, workers=site.workers,
            worker_slots=site.worker_slots, gpu_workers=site.gpu_workers,
            gpu_slots=site.gpu_slots, slurm=site.slurm,
            autoscale=site.autoscale, monitor=True,
            poll_interval_s=self.poll_interval_s)
        merged.update(kw)
        merged.update(site.cluster_kw)
        return KsaCluster(**merged)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FederatedCluster":
        with self._lock:
            if self._stopped:
                raise RuntimeError("FederatedCluster was stopped; "
                                   "create a new instance")
            if self._started:
                raise RuntimeError("FederatedCluster already started")
            self._started = True
            try:
                for cluster in self.clusters.values():
                    cluster.start()
                if self._telemetry_enabled:
                    # the home collector tails every remote site's telemetry
                    # topic directly, so one home /query answers
                    # sum_by("site") across the federation — no extra
                    # merge protocol on top of the metrics one
                    for s in self.remote_sites:
                        remote = self.clusters[s.name]
                        self.home.telemetry_collector.add_feed(
                            remote.broker,
                            topic_names(remote.prefix)["telemetry"],
                            site=s.name)
                for s in self.remote_sites:
                    self._start_bridge(
                        s, role="affinity",
                        profile=self.router.affinity_profile(s.name),
                        slots=self.bridge_slots)
                if self._spill_cfg is not None:
                    self.spillover = SpilloverController(
                        self, self._spill_cfg).start()
                self.home.monitor.attach_federation(self._sites_payload,
                                                    self.metrics_text)
            except BaseException:
                self.stop()
                raise
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Idempotent teardown: spillover loop first (stop raising
        bridges), then every bridge (stop relaying before the remote
        control planes go away), then remote clusters, home last (its
        monitor is the federated API)."""
        with self._lock:
            if not self._started or self._stopped:
                self._stopped = True
                return
            self._stopped = True
            spill, bridges = self.spillover, list(self._bridges)
        if spill is not None:
            spill.stop(timeout=timeout)
        for b in bridges:
            b.stop(timeout=timeout)
        for name, cluster in self.clusters.items():
            if name != self.home_site.name:
                cluster.stop(timeout=timeout)
        self.home.stop(timeout=timeout)

    def __enter__(self) -> "FederatedCluster":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @property
    def started(self) -> bool:
        return self._started and not self._stopped

    # -- bridges -----------------------------------------------------------

    def _start_bridge(self, site: Site, *, role: str,
                      profile: ResourceProfile, slots: int
                      ) -> SiteBridgeAgent:
        bridge = SiteBridgeAgent(
            self.home.broker, self.clusters[site.name], site, self.prefix,
            role=role,
            deadline_s=site.tolerance.deadline(self.task_timeout_s),
            remote_poll_s=self.remote_poll_s, profile=profile, slots=slots,
            placement=self.router,
            poll_interval_s=self.poll_interval_s).start()
        with self._lock:
            self._bridges.append(bridge)
        return bridge

    def _start_spill_bridge(self, site: Site, cls: str, *,
                            slots: int) -> SiteBridgeAgent:
        """Raise a bridge draining the home ``cls`` topic to ``site`` (the
        spillover controller's actuator). The taint-exclusive profile makes
        the bridge subscribe to exactly that class topic — it competes with
        the home pool's members in the same consumer group, so overflow
        partitions rebalance to it without touching queued records."""
        return self._start_bridge(
            site, role=f"spill-{cls}",
            profile=ResourceProfile(labels=(cls,), taints=(cls,)),
            slots=slots)

    def _forget_bridge(self, bridge: SiteBridgeAgent) -> None:
        with self._lock:
            if bridge in self._bridges:
                self._bridges.remove(bridge)

    def bridges(self, site: str | None = None) -> list[SiteBridgeAgent]:
        with self._lock:
            return [b for b in self._bridges
                    if site is None or b.site.name == site]

    # -- task API (KsaCluster-compatible) ----------------------------------

    @staticmethod
    def _resources(site: str, input_mb: float,
                   resources: Resources | None,
                   kw: dict) -> Resources | None:
        if resources is None:
            if not site and not input_mb:
                return None
            resources = Resources(cpus=kw.pop("cpus", 1),
                                  gpus=kw.pop("gpus", 0),
                                  mem_mb=kw.pop("mem_mb", 1024),
                                  labels=tuple(kw.pop("labels", ())))
        if site:
            resources.site = site
        if input_mb:
            resources.input_mb = input_mb
        return resources

    def submit(self, script: str, *, site: str = "", input_mb: float = 0.0,
               resources: Resources | None = None, **kw: Any) -> str:
        """Submit one task. ``site`` pins it to a federation member
        (``site=<home>`` forces local execution); ``input_mb`` declares its
        input weight for data-locality scoring and WAN transfer time."""
        res = self._resources(site, input_mb, resources, kw)
        if res is not None:
            kw["resources"] = res
        return self.home.submit(script, **kw)

    def submit_batches(self, script: str, items: Any, *, site: str = "",
                       input_mb: float = 0.0,
                       resources: Resources | None = None,
                       **kw: Any) -> list[str]:
        res = self._resources(site, input_mb, resources, kw)
        if res is not None:
            kw["resources"] = res
        return self.home.submit_batches(script, items, **kw)

    def wait_all(self, task_ids: list[str], timeout: float = 60.0,
                 poll: float = 0.02) -> bool:
        return self.home.wait_all(task_ids, timeout=timeout, poll=poll)

    def task(self, task_id: str):
        return self.home.task(task_id)

    def result(self, task_id: str) -> dict | None:
        return self.home.result(task_id)

    def revoke(self, task_id: str, reason: str = RevokeReason.SCANCEL, *,
               requeue: bool | None = None) -> bool:
        """Operator ``scancel`` at federation scope: revoking the home
        lease cancels a bridge relay too — the bridge revokes the remote
        copy and fences its verdict (see
        :mod:`repro_torch.federation.bridge`)."""
        return self.home.revoke(task_id, reason, requeue=requeue)

    # -- campaigns ---------------------------------------------------------

    @property
    def pipeline(self):
        """The home PipelineAgent — campaign stages pin to sites via
        ``Stage(resources=Resources(site=...))`` and spill like any other
        class-routed work."""
        return self.home.pipeline

    def submit_campaign(self, spec: Any, items: Iterable | None = None,
                        **kw: Any) -> str:
        return self.home.submit_campaign(spec, items, **kw)

    def run_campaign(self, spec: Any, items: Iterable | None = None,
                     **kw: Any):
        return self.home.run_campaign(spec, items, **kw)

    def campaign_status(self, campaign_id: str):
        return self.home.campaign_status(campaign_id)

    def campaign_report(self, campaign_id: str):
        """Home-plane critical path. A relayed task's queue/run split counts
        the WAN relay as run time — the home span closes when the bridge
        commits the returned verdict."""
        return self.home.campaign_report(campaign_id)

    def wait_campaign(self, campaign_id: str, timeout: float = 60.0):
        return self.home.wait_campaign(campaign_id, timeout=timeout)

    # -- observability -----------------------------------------------------

    @property
    def http_port(self) -> int | None:
        return self.home.http_port

    def metrics_text(self) -> str:
        """Federated Prometheus exposition: every site registry's render
        merged with a ``site`` label (served at the home monitor's
        ``GET /metrics``) — one scrape sees queue depths, lease churn, and
        bridge traffic across the whole federation."""
        return merge_renders({name: c.broker.metrics.render()
                              for name, c in self.clusters.items()})

    def query(self, name: str, **kw: Any) -> dict:
        """Query the home telemetry store — carries ``site``-labelled
        series from every federated feed, so ``agg="sum_by", by="site"``
        answers one question across the whole federation."""
        return self.home.query(name, **kw)

    def alerts(self) -> dict:
        """Home alert-engine status (rules evaluate over federated series)."""
        return self.home.alerts()

    def dump_blackbox(self, trigger: str = "manual") -> dict:
        """Force a post-mortem dump of the home flight recorder."""
        return self.home.dump_blackbox(trigger)

    def _sites_payload(self) -> dict:
        """The home monitor's ``GET /sites`` payload."""
        with self._lock:
            bridges = list(self._bridges)
        sites: dict[str, Any] = {}
        for s in self.sites:
            cluster = self.clusters[s.name]
            entry = s.to_dict()
            entry["home"] = s.name == self.home_site.name
            entry["prefix"] = cluster.prefix
            entry["broker"] = cluster.broker.stats()
            entry["leases"] = cluster.broker.lease_stats()
            entry["bridges"] = [
                {"agent_id": b.agent_id, "role": b.role,
                 "deadline_s": b.deadline_s, **b.stats()}
                for b in bridges if b.site.name == s.name]
            sites[s.name] = entry
        out = {"home": self.home_site.name, "sites": sites}
        if self.spillover is not None:
            out["spillover"] = self.spillover.status()
        return out

    def status(self) -> dict:
        """Aggregated federation snapshot: the home cluster's status plus
        the per-site payload ``GET /sites`` serves."""
        out = self.home.status()
        out["federation"] = self._sites_payload()
        return out

    def trace(self, task_id: str) -> list[dict]:
        """Home-plane span chain for a task; a relayed task's remote spans
        live in the remote site's own store
        (``clusters[site].trace(task_id)``)."""
        return self.home.trace(task_id)
