"""repro_torch.federation — multi-site control plane over independent KSA sites.

Composes N single-site deployments (each a full
:class:`~repro_torch.cluster.KsaCluster`: own broker, pools, monitor) into one
federation behind the familiar API:

* :class:`Site` / :class:`WanLink` — declarative site description: pools,
  cold-start and slot cost, a modeled WAN link (latency, bandwidth,
  partitionable), and a :class:`~repro_torch.core.lease.LeaseTolerance` for
  WAN-tolerant lease deadlines.
* :class:`SiteRouter` — placement with site affinity (``Resources.site``
  pins route to a per-site class), data locality (``Resources.input_mb``
  priced against link bandwidth), and spill scoring (cold-start vs
  slot-seconds vs transfer).
* :class:`~repro_torch.federation.bridge.SiteBridgeAgent` — the home-side relay
  that ships leased tasks to a remote site and gates their verdicts back
  through the home lease, keeping exactly-once across sites.
* :class:`SpilloverConfig` / :class:`SpilloverController` — backlog vs
  drain-rate sensing that borrows the cheapest remote site's capacity
  when the home site falls behind, and hands it back when idle.
* :class:`FederatedCluster` — the facade wiring all of it, serving
  federated ``/sites`` and site-labelled ``/metrics`` from the home
  monitor.
"""
from .bridge import SiteBridgeAgent
from .cluster import FederatedCluster
from .router import SiteRouter, site_class
from .site import Site, WanLink
from .spillover import SpilloverConfig, SpilloverController

__all__ = [
    "FederatedCluster",
    "Site",
    "SiteBridgeAgent",
    "SiteRouter",
    "SpilloverConfig",
    "SpilloverController",
    "WanLink",
    "site_class",
]
