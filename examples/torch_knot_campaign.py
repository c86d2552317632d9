"""The paper's application on the PyTorch port: the AlphaKnot-style
3-stage campaign (screen → localize → aggregate) over synthetic protein
backbones, with a mid-campaign agent failure and a flat-baseline parity
check (``examples/knot_campaign.py`` on ``repro_torch``; its docstring
explains the journal, leases, autoscaling, telemetry and federation this
example drives).

Every stage computes its writhe maps on ``--device``: on a CUDA device the
port's writhe kernel, on the CPU its plain version.

* default: one ``KsaCluster`` with a simulated Slurm cluster and a
  workstation worker that is killed mid-campaign (the watchdog redelivers);
* ``--autoscale``: elastic cpu/gpu pools, the localize stage on the GPU
  class;
* ``--sites 2``: the campaign on an ``edge`` + ``hpc``
  :class:`~repro_torch.federation.FederatedCluster`, the localize stage
  pinned to the remote HPC site behind a modeled WAN link, the screen
  spilling there on backlog.

Run:  PYTHONPATH=src python examples/torch_knot_campaign.py [--structures 128]
          [--autoscale] [--sites 2] [--device cpu]
"""
import argparse
import json
import threading
import time
import urllib.request

from repro_torch.apps import knots  # registers knot_* scripts
from repro_torch.cluster import KsaCluster
from repro_torch.convert import resolve_device
from repro_torch.core import Broker
from repro_torch.obs import SloSpec


def flat_baseline(broker: Broker, structures: int, batch_size: int,
                  n_points: int, device: str) -> dict:
    """The pre-pipeline flat submission (one bag of knot_batch tasks),
    used to check the campaign reports identical knot counts."""
    with KsaCluster(prefix="flat", broker=broker) as c:
        for _ in range(2):
            c.add_worker(slots=1)
        ids = list(range(structures))
        t0 = time.time()
        tids = c.submit_batches("knot_batch", ids, batch_size=batch_size,
                                params={"n_points": n_points, "stage2": True,
                                        "device": device})
        assert c.wait_all(tids, timeout=900.0), "flat baseline stalled"
        dt = time.time() - t0
        knotted, cores = set(), {}
        for t in tids:
            r = c.result(t)
            knotted.update(r["knotted"])
            cores.update(r["cores"])
    return {"knotted": sorted(knotted), "cores": cores, "elapsed_s": dt}


def check_baseline(args, broker: Broker, agg: dict) -> None:
    base = flat_baseline(broker, args.structures, args.batch_size,
                         args.n_points, args.device)
    match = base["knotted"] == agg["knotted"]
    print(f"flat baseline: {len(base['knotted'])} knotted in "
          f"{base['elapsed_s']:.1f}s — counts "
          f"{'MATCH' if match else 'MISMATCH'}")
    assert match, (base["knotted"], agg["knotted"])
    assert set(base["cores"]) == set(agg["cores"])


def federated_main(args) -> None:
    """--sites 2: the campaign on an edge + HPC federation."""
    from repro_torch.federation import (FederatedCluster, Site,
                                        SpilloverConfig, WanLink)
    gpu = resolve_device(args.device).type == "cuda"
    sites = [
        Site("edge", workers=2, worker_slots=1,
             cluster_kw={"pipeline_task_timeout_s": 20.0,
                         "partitioner": "balanced",
                         "default_partitions": 8}),
        # on a card the HPC site's GPU worker takes the localize stage
        Site("hpc", workers=2, worker_slots=2, gpu_workers=int(gpu),
             spinup_s=0.5, slot_cost=1.5,
             link=WanLink(latency_s=0.01, bandwidth_mbps=500.0),
             cluster_kw={"partitioner": "balanced",
                         "default_partitions": 8}),
    ]
    spill = SpilloverConfig(classes=("cpu",), horizon_s=0.3, min_backlog=2,
                            interval_s=0.05, cooldown_s=0.2,
                            drain_idle_s=0.5, bridge_slots=2,
                            max_bridges_per_class=2)
    with FederatedCluster(sites, prefix="alphaknot", http=True,
                          spillover=spill) as fed:
        spec = knots.knots_pipeline(args.batch_size, n_points=args.n_points,
                                    task_timeout_s=20.0, gpu_localize=gpu,
                                    localize_site="hpc", device=args.device)
        ids = list(range(args.structures))
        print(f"federated campaign: {len(ids)} structures on {args.device}, "
              f"home=edge (2x1 slots), remote=hpc (2x2 slots"
              f"{' + 1 GPU worker' if gpu else ''}, 10ms WAN); localize "
              f"pinned to hpc, screen spills on backlog")
        res = fed.run_campaign(spec, ids, timeout_s=900.0)
        agg = res.final
        print(f"\nprocessed {agg['processed']} structures in "
              f"{res.elapsed_s:.1f}s -> state {res.status.state}")
        print(f"knotted: {len(agg['knotted'])}")
        assert res.status.state == "COMPLETED", res.status.state

        with urllib.request.urlopen(
                f"http://127.0.0.1:{fed.http_port}/sites") as r:
            payload = json.loads(r.read())
        for name, s in payload["sites"].items():
            roles = [b["role"] for b in s["bridges"]]
            print(f"site {name}{' (home)' if s['home'] else ''}: "
                  f"leases completed {s['leases']['completed']}, "
                  f"bridges {roles or '[]'}")
        for d in payload.get("spillover", {}).get("decisions", [])[-4:]:
            print(f"  spillover: {d['action']} {d['cls']} -> {d['site']} "
                  f"({d['reason']})")
        relayed = sum(b.tasks_completed for b in fed.bridges())
        site_lines = sum(1 for ln in fed.metrics_text().splitlines()
                         if 'site="hpc"' in ln)
        print(f"{relayed} tasks relayed over the WAN; federated /metrics "
              f"has {site_lines} hpc-labelled samples")
        if not args.skip_baseline:
            check_baseline(args, fed.home.broker, agg)
    print("OK")


def single_site_cluster(args) -> KsaCluster:
    # telemetry plane: queue-wait p95 under 15 s, as in the reference
    telemetry_kw = dict(
        telemetry=True,
        slos=[SloSpec(name="queue-wait-p95",
                      metric="ksa_task_queue_wait_seconds:p95",
                      objective=15.0, q=0.95)])
    if args.autoscale:
        from repro_torch.autoscale import AutoscaleConfig, PoolSpec
        return KsaCluster(
            prefix="alphaknot", session_timeout_s=2.0,
            pipeline_task_timeout_s=20.0, http=True,
            autoscale=AutoscaleConfig(
                pools=(PoolSpec("cpu", min_agents=1, max_agents=4, slots=2),
                       PoolSpec("gpu", min_agents=0, max_agents=2, slots=1)),
                interval_s=0.02),
            **telemetry_kw)
    return KsaCluster(prefix="alphaknot", session_timeout_s=2.0,
                      slurm=dict(nodes=2, cpus_per_node=2, oversubscribe=2),
                      pipeline_task_timeout_s=20.0, http=True,
                      **telemetry_kw)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--structures", type=int, default=96)
    ap.add_argument("--batch-size", type=int, default=12)
    ap.add_argument("--n-points", type=int, default=96)
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic cpu/gpu pools instead of the static "
                         "cluster+workstation layout; the localize stage "
                         "then runs on the GPU class")
    ap.add_argument("--sites", type=int, default=1, choices=(1, 2),
                    help="2 = run the campaign on a two-site federation: "
                         "localize pinned to the remote HPC site, screen "
                         "spilling on backlog")
    ap.add_argument("--device", default="cuda",
                    help="where the writhe maps are computed (cuda or cpu)")
    args = ap.parse_args()
    resolve_device(args.device)

    if args.sites == 2:
        federated_main(args)
        return

    with single_site_cluster(args) as c:
        spec = knots.knots_pipeline(args.batch_size, n_points=args.n_points,
                                    task_timeout_s=20.0,
                                    gpu_localize=args.autoscale,
                                    device=args.device)
        ids = list(range(args.structures))
        print(f"campaign: {len(ids)} structures on {args.device} through "
              f"3-stage pipeline {[s.name for s in spec.topological()]}"
              f"{' (autoscaled pools)' if args.autoscale else ''}")

        if not args.autoscale:
            workstation = c.add_worker(slots=1, heartbeat_interval_s=0.2,
                                       profile=None)

            def killer() -> None:
                # a node dies mid-campaign; the watchdog redelivers
                time.sleep(1.0)
                print("!! killing the workstation agent mid-campaign")
                workstation.crash()
            threading.Thread(target=killer, daemon=True).start()

        res = c.run_campaign(spec, ids, timeout_s=900.0)
        agg = res.final
        assert res.status.state == "COMPLETED", res.status.state
        print(f"\nprocessed {agg['processed']} structures in "
              f"{res.elapsed_s:.1f}s ({agg['processed']/res.elapsed_s:.1f}/s)"
              f"{'' if args.autoscale else ' despite the failure'}")
        print(f"knotted: {len(agg['knotted'])}")
        for sid, (a, b) in list(agg["cores"].items())[:5]:
            print(f"  structure {sid}: knot core ≈ residues [{a}, {b})")
        retried = sum(s.retried for s in res.status.stages.values())
        fenced = sum(s.duplicates for s in res.status.stages.values())
        skipped = sum(s.skipped for s in res.status.stages.values())
        print(f"pipeline: {retried} watchdog resubmissions, "
              f"{fenced} duplicate results fenced, "
              f"{skipped} empty localize tasks skipped")

        rep = c.campaign_report(res.campaign_id)
        print(f"critical path: wall {rep['wall_s']:.1f}s, dominant stage "
              f"'{rep['dominant_stage']}'")
        for name, s in rep["stages"].items():
            print(f"  {name:>9}: queue {s['queue_s']:6.2f}s  "
                  f"run {s['run_s']:6.2f}s  retry {s['retry_s']:5.2f}s  "
                  f"({s['tasks']} tasks, {s['retries']} retried)")
        c.telemetry_publisher.publish_once()  # flush the final snapshot
        drain = c.query("ksa_leases_completed_total", agg="rate",
                        window_s=max(10.0, res.elapsed_s))
        alerts = c.alerts()
        print(f"telemetry: drain rate {drain['result']:.1f} tasks/s; SLO "
              f"'{alerts['rules'][0]}': "
              f"{'FIRING' if alerts['firing'] else 'within objective'}")
        if not args.skip_baseline:
            check_baseline(args, c.broker, agg)
    print("OK")


if __name__ == "__main__":
    main()
