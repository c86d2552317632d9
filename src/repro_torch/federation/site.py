"""Site and WAN-link modeling for the federated control plane.

A federation composes N independent KSA deployments — the paper's target
shape, "multiple Slurm-managed HPC clusters and workstations" — where each
:class:`Site` has its own broker, pools, cold-start and cost profile, and
sits behind a modeled :class:`WanLink`. The link is the part a single-site
deployment never has to think about: latency delays every task/result
relay, bandwidth charges each task's ``Resources.input_mb``, and a
partition (``link.partition()`` / ``link.heal()``) blocks relays entirely
while leaving both sites' local control planes running — the scenario the
WAN-tolerant lease deadline (:class:`~repro_torch.core.lease.LeaseTolerance`)
exists for.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Mapping

from repro_torch.core.lease import LeaseTolerance

__all__ = ["Site", "WanLink"]


class WanLink:
    """One site's WAN connection to the federation's home site.

    Latency/bandwidth are a fixed one-way model: shipping ``mb`` megabytes
    takes ``latency_s + mb * 8 / bandwidth_mbps`` seconds each way. The
    ``up`` flag is mutable at runtime — :meth:`partition` / :meth:`heal`
    simulate a WAN cut; bridges stop relaying (and stop heartbeating on
    behalf of remote work) while the link is down.
    """

    def __init__(self, latency_s: float = 0.0,
                 bandwidth_mbps: float = 1000.0) -> None:
        if latency_s < 0:
            raise ValueError(f"latency_s must be >= 0 (got {latency_s!r})")
        if bandwidth_mbps <= 0:
            raise ValueError(
                f"bandwidth_mbps must be > 0 (got {bandwidth_mbps!r})")
        self.latency_s = latency_s
        self.bandwidth_mbps = bandwidth_mbps
        self._down = threading.Event()

    @property
    def up(self) -> bool:
        return not self._down.is_set()

    def partition(self) -> None:
        """Cut the link: bridge relays block until :meth:`heal`."""
        self._down.set()

    def heal(self) -> None:
        self._down.clear()

    def one_way_s(self, mb: float = 0.0) -> float:
        """Modeled one-way delivery time for ``mb`` megabytes."""
        return self.latency_s + (mb * 8.0) / self.bandwidth_mbps

    def round_trip_s(self, mb: float = 0.0) -> float:
        return self.one_way_s(mb) + self.one_way_s()

    def to_dict(self) -> dict:
        return {"latency_s": self.latency_s,
                "bandwidth_mbps": self.bandwidth_mbps,
                "up": self.up}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "up" if self.up else "DOWN"
        return (f"WanLink(latency_s={self.latency_s}, "
                f"bandwidth_mbps={self.bandwidth_mbps}, {state})")


@dataclass
class Site:
    """Declarative description of one federation member.

    The first site passed to :class:`~repro_torch.federation.FederatedCluster` is
    the **home** site: submissions enter there, its monitor serves the
    federated REST API, and its broker holds the authoritative lease per
    task. Every other site is remote — work reaches it only through a
    bridge, pinned (``Resources.site``) or spilled
    (:class:`~repro_torch.federation.SpilloverController`).

    ``workers``/``gpu_workers``/``slurm``/``autoscale`` provision the
    site's pools exactly like the same-named :class:`~repro_torch.cluster.
    KsaCluster` kwargs. ``spinup_s`` is the modeled cold-start a spill
    decision charges against this site (a Slurm site's node spin-up; pass
    the same value inside ``slurm`` to actually simulate it), ``slot_cost``
    the relative price of one slot-second there, and ``tolerance`` the
    WAN-lease policy knob: how much longer than the home watchdog deadline
    a lease held across this site's ``link`` may go quiet before it is
    presumed dead."""

    name: str
    workers: int = 0
    worker_slots: int = 2
    gpu_workers: int = 0
    gpu_slots: int = 1
    slurm: Mapping[str, Any] | None = None
    autoscale: Any = None                  # AutoscaleConfig | None
    link: WanLink = field(default_factory=WanLink)
    spinup_s: float = 0.0
    slot_cost: float = 1.0
    tolerance: LeaseTolerance = field(default_factory=LeaseTolerance)
    cluster_kw: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.name or "." in self.name:
            # site names become resource-class suffixes ("site.<name>") and
            # metric label values; a dot would collide with the class-topic
            # separator
            raise ValueError(
                f"site name must be non-empty and dot-free (got "
                f"{self.name!r})")

    @property
    def slots(self) -> int:
        """Nominal local slot count (workers only; a Slurm site's capacity
        lives in the simulator) — used for spill scoring, not admission."""
        return (self.workers * self.worker_slots
                + self.gpu_workers * self.gpu_slots)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "workers": self.workers,
            "gpu_workers": self.gpu_workers,
            "slurm": dict(self.slurm) if self.slurm else None,
            "link": self.link.to_dict(),
            "spinup_s": self.spinup_s,
            "slot_cost": self.slot_cost,
            "tolerance": {"slack_s": self.tolerance.slack_s,
                          "rtt_factor": self.tolerance.rtt_factor},
        }
