"""The port's federation (``repro_torch.federation``) on the CPU.

Each case of ``tests/test_federation.py``, the cross-site fencing test of
``tests/test_lease.py``, the site-label lint of ``tests/test_api_surface.py``
and the federation half and the catalog lint of ``tests/test_obs.py`` run
here through the port's own clusters, with the reference's assertions. The
waits that the reference gives 20 s get 60 s here: the relays are threads
that a loaded host may starve, and a longer wait loosens no assertion.
Then one small federated knot campaign (localize pinned to the remote
site) runs through both packages and must give the same results.
"""
import json
import pathlib
import re
import time
import urllib.request

import pytest

from repro_torch.cluster import KsaCluster
from repro_torch.core import ClusterComputing, register_script
from repro_torch.core.lease import LeaseTolerance, RevokeReason
from repro_torch.core.messages import Resources, TaskMessage, TaskStatus
from repro_torch.federation import (FederatedCluster, Site, SiteRouter,
                                    SpilloverConfig, SpilloverController,
                                    WanLink, site_class)
from test_obs import _lint_prometheus

REPO = pathlib.Path(__file__).resolve().parent.parent
WAIT_S = 60.0


def _wait(cond, timeout=10.0, interval=0.01):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _task(task_id="t1", script="sleep", **res):
    return TaskMessage(task_id=task_id, script=script,
                       resources=Resources(**res))


@register_script("lease_hang_once")
class _HangOnce(ClusterComputing):
    """Hangs (cancellably) on attempt 0, completes instantly afterwards
    (``tests/test_lease.py``'s straggler, in the port's registry)."""

    def run(self):
        if self.attempt == 0:
            while True:
                self.check_cancel()
                time.sleep(0.005)
        return {"attempt": self.attempt}


# -- model ------------------------------------------------------------------


def test_wanlink_transfer_model():
    link = WanLink(latency_s=0.05, bandwidth_mbps=100.0)
    assert link.one_way_s() == pytest.approx(0.05)
    assert link.one_way_s(10.0) == pytest.approx(0.85)
    assert link.round_trip_s(10.0) == pytest.approx(0.90)
    assert link.up
    link.partition()
    assert not link.up and link.to_dict()["up"] is False
    link.heal()
    assert link.up
    with pytest.raises(ValueError):
        WanLink(latency_s=-1.0)
    with pytest.raises(ValueError):
        WanLink(bandwidth_mbps=0.0)


def test_site_name_validation():
    with pytest.raises(ValueError):
        Site("")
    with pytest.raises(ValueError):
        Site("a.b")
    assert Site("hpc", workers=2, worker_slots=3).slots == 6


def test_lease_tolerance_deadline():
    assert LeaseTolerance().deadline(10.0) == pytest.approx(10.0)
    t = LeaseTolerance(slack_s=2.0, rtt_factor=1.5)
    assert t.deadline(10.0) == pytest.approx(17.0)
    assert t.deadline(None) == pytest.approx(2.0)
    assert LeaseTolerance().deadline(None) is None


# -- routing ----------------------------------------------------------------


def test_site_router_classification():
    router = SiteRouter(["a", "b"], home="a")
    assert site_class("b") in router.classes()
    assert site_class("a") not in router.classes()
    assert router.classify(_task(site="b")) == site_class("b")
    assert router.classify(_task(site="a")) == "cpu"
    assert router.classify(_task()) == "cpu"
    assert router.classify(_task(gpus=1)) == "gpu"
    with pytest.raises(ValueError):
        router.classify(_task(site="nowhere"))
    with pytest.raises(ValueError):
        SiteRouter(["a", "b"], home="c")


def test_affinity_profile_subscribes_only_to_site_class():
    from repro_torch.core.scheduling import ResourceProfile
    router = SiteRouter(["a", "b"], home="a")
    prof = router.affinity_profile("b")
    assert router.subscriptions("ksa", prof) == (f"ksa-new.{site_class('b')}",)
    cpu = ResourceProfile(cpus=2, mem_mb=2048)
    assert f"ksa-new.{site_class('b')}" not in \
        router.subscriptions("ksa", cpu)


def test_spill_score_prices_coldstart_slots_and_transfer():
    router = SiteRouter(["a", "b", "c"], home="a")
    cheap = Site("b", link=WanLink(latency_s=0.01, bandwidth_mbps=1000.0))
    pricey = Site("c", spinup_s=5.0, slot_cost=3.0,
                  link=WanLink(latency_s=0.2, bandwidth_mbps=10.0))
    assert router.spill_score(cheap) < router.spill_score(pricey)
    heavy = _task(input_mb=100.0)
    assert router.spill_score(cheap, heavy) > router.spill_score(cheap)
    pricey.link.partition()
    assert router.spill_score(pricey) == float("inf")


# -- federated execution ----------------------------------------------------


def test_pinned_task_relays_to_remote_site():
    with FederatedCluster([Site("a", workers=1), Site("b", workers=1)],
                          task_timeout_s=30.0) as fed:
        local = fed.submit("sleep", params={"duration": 0.02}, site="a")
        remote = fed.submit("sleep", params={"duration": 0.02}, site="b",
                            input_mb=1.0)
        assert fed.wait_all([local, remote], timeout=WAIT_S)
        assert fed.result(remote) == {"slept": 0.02}
        assert fed.task(remote).agent_id.startswith("bridge-b-")
        assert not fed.task(local).agent_id.startswith("bridge-")
        entry = fed.clusters["b"].task(remote)
        assert entry is not None and entry.done
        with pytest.raises(ValueError):
            fed.submit("sleep", site="nowhere")


def test_campaign_stage_pinned_to_site():
    from repro_torch.pipeline import PipelineSpec, Stage
    spec = PipelineSpec("fedcamp", [
        Stage("local", "sleep", fan_out=2,
              params={"duration": 0.02}, resources=Resources(cpus=1)),
        Stage("remote", "sleep", depends_on=("local",), join=True,
              params={"duration": 0.02},
              resources=Resources(cpus=1, site="b")),
    ])
    with FederatedCluster([Site("a", workers=1), Site("b", workers=1)],
                          task_timeout_s=30.0) as fed:
        res = fed.run_campaign(spec, list(range(4)), timeout_s=WAIT_S)
        assert res.status.state == "COMPLETED"
        entries = fed.clusters["b"].monitor.tasks()
        assert any(e.done for e in entries.values())


def test_remote_failure_propagates_home():
    with FederatedCluster([Site("a", workers=1), Site("b", workers=1)],
                          max_attempts=1) as fed:
        tid = fed.submit("fail", params={"fail_times": 5}, site="b")
        assert _wait(lambda: fed.task(tid) is not None
                     and fed.task(tid).errors, timeout=WAIT_S)
        e = fed.task(tid)
        assert not e.done
        assert "site b" in e.errors[-1]["error"]


def test_bridge_requires_remote_monitor():
    fed = FederatedCluster([
        Site("a", workers=1),
        Site("b", workers=1, cluster_kw={"monitor": False})])
    with pytest.raises(ValueError, match="monitor"):
        fed.start()
    fed.stop()


# -- WAN-tolerant leases ----------------------------------------------------


def test_partition_within_tolerance_is_not_revoked():
    b = Site("b", workers=1, tolerance=LeaseTolerance(slack_s=60.0))
    with FederatedCluster([Site("a", workers=1), b],
                          task_timeout_s=0.5) as fed:
        tid = fed.submit("sleep", params={"duration": 0.2}, site="b")
        assert _wait(lambda: fed.home.broker.lease_view(tid) is not None,
                     timeout=10.0)
        lease = fed.home.broker.lease_view(tid)
        assert lease["site"] == "b"
        assert lease["deadline_s"] == pytest.approx(60.5)
        b.link.partition()
        time.sleep(1.2)
        b.link.heal()
        assert fed.wait_all([tid], timeout=WAIT_S)
        e = fed.task(tid)
        assert e.result_attempt == 0
        assert e.duplicate_results == 0
        revoked = fed.home.broker.lease_stats()["revoked"]
        assert revoked.get(RevokeReason.WATCHDOG, 0) == 0


def test_partition_beyond_tolerance_recovers_via_watchdog():
    b = Site("b", workers=1)
    with FederatedCluster([Site("a", workers=1), b],
                          task_timeout_s=0.4) as fed:
        tid = fed.submit("sleep", params={"duration": 0.2}, site="b")
        assert _wait(lambda: fed.home.broker.lease_view(tid) is not None,
                     timeout=10.0)
        b.link.partition()
        time.sleep(1.0)
        b.link.heal()
        assert fed.wait_all([tid], timeout=WAIT_S)
        e = fed.task(tid)
        assert e.done
        assert e.duplicate_results == 0


# -- cross-site revocation fencing ------------------------------------------


def test_cross_site_preemption_fences_remote_verdict():
    b = Site("b", workers=1, link=WanLink(latency_s=0.2))
    with FederatedCluster([Site("a", workers=1), b],
                          task_timeout_s=60.0) as fed:
        tid = fed.submit("sleep", params={"duration": 1.0}, site="b")
        remote = fed.clusters["b"]
        assert _wait(lambda: (remote.task(tid) is not None and
                              remote.task(tid).status ==
                              TaskStatus.RUNNING.value), timeout=WAIT_S)
        assert fed.revoke(tid, RevokeReason.PREEMPT)
        assert fed.wait_all([tid], timeout=WAIT_S)
        e = fed.task(tid)
        assert e.duplicate_results == 0
        assert e.result_attempt >= 1
        remote_revoked = remote.broker.lease_stats()["revoked"]
        assert remote_revoked.get(RevokeReason.PREEMPT, 0) >= 1


def test_cross_site_spill_preempted_never_commits_from_both():
    """tests/test_lease.py's fencing case: the preempted relay's verdict is
    dropped, the remote copy revoked, one completion committed at home."""
    b = Site("b", workers=1, link=WanLink(latency_s=0.2))
    with FederatedCluster([Site("a", workers=1), b],
                          task_timeout_s=60.0) as fed:
        tid = fed.submit("lease_hang_once", site="b")
        remote = fed.clusters["b"]
        assert _wait(lambda: remote.broker.lease_view(tid) is not None,
                     timeout=WAIT_S)
        home_lease = fed.home.broker.lease_view(tid)
        assert home_lease is not None and home_lease["site"] == "b"
        assert fed.revoke(tid, RevokeReason.PREEMPT)
        assert fed.wait_all([tid], timeout=WAIT_S)
        e = fed.task(tid)
        assert e.done and e.duplicate_results == 0
        assert e.result_attempt >= 1
        assert e.result["attempt"] >= 1
        assert remote.broker.lease_stats()["revoked"].get(
            RevokeReason.PREEMPT, 0) >= 1
        snap = fed.home.broker.metrics.snapshot()
        events = snap["ksa_bridge_events_total"]["series"]
        fenced = sum(v for k, v in events.items() if k[-1] == "fenced")
        remote_revoked = sum(v for k, v in events.items()
                             if k[-1] == "remote_revoked")
        assert fenced >= 1 and remote_revoked >= 1
        assert fed.home.broker.lease_stats()["completed"] == 1


# -- spillover --------------------------------------------------------------


def test_spillover_borrows_and_returns_remote_capacity():
    cfg = SpilloverConfig(classes=("cpu",), horizon_s=0.5, min_backlog=2,
                          cooldown_s=0.0, drain_idle_s=0.05,
                          bridge_slots=2, max_bridges_per_class=2)
    with FederatedCluster([Site("a", workers=0),
                           Site("b", workers=1, worker_slots=2)]) as fed:
        ctl = SpilloverController(fed, cfg)
        tids = [fed.submit("sleep", params={"duration": 0.05})
                for _ in range(6)]
        ctl.tick()
        assert ctl.bridge_count("cpu") >= 1
        assert fed.bridges("b")
        assert fed.wait_all(tids, timeout=WAIT_S)
        assert _wait(lambda: (ctl.tick() or ctl.bridge_count("cpu") == 0),
                     timeout=WAIT_S, interval=0.05)
        assert _wait(lambda: (ctl.tick() or
                              [b.role for b in fed.bridges("b")] ==
                              ["affinity"]),
                     timeout=WAIT_S, interval=0.05)
        st = ctl.status()
        actions = [d["action"] for d in st["decisions"]]
        assert "spill" in actions and "release" in actions
        assert st["classes"]["cpu"]["spills"] >= 1


def test_spillover_rejects_unknown_class():
    with FederatedCluster([Site("a", workers=1), Site("b")]) as fed:
        with pytest.raises(ValueError, match="resource class"):
            SpilloverController(fed, SpilloverConfig(classes=("warp",)))


# -- federated observability ------------------------------------------------


def test_sites_endpoint_and_federated_metrics():
    with FederatedCluster([Site("a", workers=1), Site("b", workers=1)],
                          http=True) as fed:
        tid = fed.submit("sleep", params={"duration": 0.02}, site="b")
        assert fed.wait_all([tid], timeout=WAIT_S)
        port = fed.http_port
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/sites") as r:
            payload = json.loads(r.read())
        assert payload["home"] == "a"
        assert set(payload["sites"]) == {"a", "b"}
        assert payload["sites"]["b"]["bridges"], "affinity bridge missing"
        assert payload["sites"]["b"]["broker"]["site"] == "b"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics") as r:
            text = r.read().decode()
        assert 'site="a"' in text and 'site="b"' in text
        for line in text.splitlines():
            if line and not line.startswith("#"):
                assert 'site="' in line, f"unlabelled sample: {line}"
    with KsaCluster(workers=1, http=True) as c:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{c.http_port}/metrics") as r:
            text = r.read().decode()
        assert 'site="' not in text


def test_home_query_answers_sum_by_site_across_the_federation():
    fed = FederatedCluster(
        [Site("home", workers=1), Site("edge", workers=1)],
        prefix="fedq", http=True, telemetry=True)
    with fed:
        ids = [fed.submit("sleep", params={"duration": 0.01})
               for _ in range(4)]
        ids.append(fed.submit("sleep", site="edge",
                              params={"duration": 0.01}))
        assert fed.wait_all(ids, timeout=WAIT_S)
        for cluster in fed.clusters.values():
            cluster.telemetry_publisher.publish_once()
        out = fed.query("ksa_leases_granted_total", agg="sum_by", by="site")
        assert set(out["result"]) == {"home", "edge"}
        assert out["result"]["home"] >= 4
        assert out["result"]["edge"] >= 1
        with urllib.request.urlopen(
                f"http://127.0.0.1:{fed.http_port}/query?"
                f"name=ksa_leases_granted_total&agg=sum_by&by=site") as r:
            data = json.loads(r.read())
        assert set(data["result"]) == {"home", "edge"}
        assert data["result"] == out["result"]
        edge_grants = fed.query("ksa_leases_granted_total", agg="sum",
                                labels={"site": "edge"})
        assert edge_grants["result"] >= 1
        assert fed.alerts()["rules"] == []
        assert fed.dump_blackbox()["trigger"] == "manual"


def test_every_registered_metric_is_site_labelled_under_federation():
    """tests/test_api_surface.py's lint: the home monitor's exposition
    covers every ksa_ family of every site, each sample site-labelled."""
    with FederatedCluster([Site("a", workers=1), Site("b", workers=1)],
                          task_timeout_s=30.0) as fed:
        tids = [fed.submit("sleep", params={"duration": 0.01}),
                fed.submit("sleep", params={"duration": 0.01}, site="b")]
        assert fed.wait_all(tids, timeout=WAIT_S)
        merged = fed.home.monitor.metrics_text()
        sample_lines = [ln for ln in merged.splitlines()
                        if ln and not ln.startswith("#")]
        assert sample_lines
        for ln in sample_lines:
            assert 'site="' in ln, f"unlabelled sample line: {ln}"
        for name, cluster in fed.clusters.items():
            snap = cluster.broker.metrics.snapshot()
            for family, data in snap.items():
                if not family.startswith("ksa_") or not data["series"]:
                    continue
                pat = re.compile(
                    rf"^{re.escape(family)}(?:_\w+)?\{{[^}}]*"
                    rf"site=\"{re.escape(name)}\"", re.M)
                assert pat.search(merged), \
                    (f"metric {family} of site {name} missing from the "
                     f"federated /metrics exposition")


def test_prometheus_conformance_federation_renders():
    """The federation half of tests/test_obs.py's conformance lint, on the
    port's merge_renders and on a live federation's exposition."""
    from repro_torch.obs import merge_renders
    with KsaCluster(prefix="obs14", workers=1, telemetry=True) as c:
        ids = [c.submit("sleep", params={"duration": 0.01}) for _ in range(3)]
        assert c.wait_all(ids, timeout=WAIT_S)
        text = c.metrics_text()
        merged = merge_renders({"home": text, "edge": text})
        tagged = [lab for n, lab, _ in _lint_prometheus(merged)
                  if n.startswith("ksa_")]
        assert tagged and all(lab.get("site") in ("home", "edge")
                              for lab in tagged)
    with FederatedCluster([Site("home", workers=1), Site("edge", workers=1)],
                          prefix="obsfed", telemetry=True) as fed:
        ids = [fed.submit("sleep", params={"duration": 0.01}),
               fed.submit("sleep", site="edge", params={"duration": 0.01})]
        assert fed.wait_all(ids, timeout=WAIT_S)
        tagged = [lab for n, lab, _ in _lint_prometheus(fed.metrics_text())
                  if n.startswith("ksa_")]
        assert {lab.get("site") for lab in tagged} == {"home", "edge"}


def test_metrics_catalog_documents_every_registered_family():
    """tests/test_obs.py's catalog lint on the port: its full deployment
    registers exactly the families docs/METRICS.md documents, the same set
    as the reference's, and the rendered catalog round-trips."""
    from repro.obs.catalog import _full_registry as reference_registry
    from repro_torch.obs.catalog import (_full_registry, catalog_names,
                                         render_catalog)
    documented = catalog_names((REPO / "docs" / "METRICS.md").read_text())
    reg = _full_registry()
    registered = {r["name"] for r in reg.describe()
                  if r["name"].startswith("ksa_")}
    want = {r["name"] for r in reference_registry().describe()
            if r["name"].startswith("ksa_")}
    assert registered == documented == want, (
        sorted(registered ^ documented), sorted(registered ^ want))
    assert catalog_names(render_catalog(reg)) == registered


# -- the federated knot campaign against the reference ----------------------


def _federated_campaign(fed_mod, knots_mod, ids, **kw):
    sites = [fed_mod.Site("edge", workers=2, worker_slots=1),
             fed_mod.Site("hpc", workers=1, worker_slots=2,
                          link=fed_mod.WanLink(latency_s=0.01,
                                               bandwidth_mbps=500.0))]
    with fed_mod.FederatedCluster(sites, prefix="fedknots",
                                  poll_interval_s=0.01) as fed:
        res = fed.run_campaign(knots_mod.knots_pipeline(
            12, n_points=64, localize_site="hpc", **kw), ids,
            timeout_s=240.0)
        assert res.status.state == "COMPLETED"
        locs = [t for t in fed.home.monitor.tasks()
                if "localize" in t]
        relayed = [t for t in locs
                   if fed.task(t).agent_id.startswith("bridge-hpc-")]
        remote_done = [t for t in locs
                       if fed.clusters["hpc"].task(t) is not None
                       and fed.clusters["hpc"].task(t).done]
    return res.final, locs, relayed, remote_done


def test_federated_campaign_matches_reference():
    from repro import federation as jfed
    from repro.apps import knots as jknots
    from repro_torch import federation as tfed
    from repro_torch.apps import knots as tknots

    ids = list(range(48))
    want, *_ = _federated_campaign(jfed, jknots, ids)
    got, locs, relayed, remote_done = _federated_campaign(
        tfed, tknots, ids, device="cpu")
    assert got["processed"] == want["processed"] == 48
    assert got["kept"] == want["kept"]
    assert got["batches"] == want["batches"] == 4
    assert got["knotted"] == want["knotted"]
    assert got["knotted"], "the population must have knots"
    assert got["cores"] == want["cores"]
    assert got["mean_acn"] == pytest.approx(want["mean_acn"], rel=1e-5)
    assert locs and relayed == locs == remote_done
