"""Quickstart on the PyTorch port — the paper's Fig. 3 example, end to end
in one process (``examples/quickstart.py`` on ``repro_torch``).

A user-defined ``MatrixComputing`` task (extends ``ClusterComputing``)
computes eigenvalues of random matrices on ``--device`` with
``torch.linalg.eigvalsh``. Tasks flow through the port's
:class:`~repro_torch.cluster.KsaCluster`: its broker, a simulated Slurm
cluster, a workstation worker, and the MonitorAgent with its REST API.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import json
import urllib.request

import numpy as np
import torch

from repro_torch.cluster import KsaCluster
from repro_torch.convert import resolve_device
from repro_torch.core import ClusterComputing, register_script


@register_script("matrix")
class MatrixComputing(ClusterComputing):
    """Paper Fig. 3: the user overrides run(), reads self.params, and may
    emit custom status updates mid-computation."""

    def run(self):
        n = int(self.params.get("n", 128))
        seed = int(self.params.get("seed", 0))
        dev = resolve_device(self.params.get("device", "cuda"))
        self.send_status("RUNNING", phase="generating", n=n)
        a = np.random.RandomState(seed).randn(n, n)
        a = torch.from_numpy((a + a.T) / 2).to(dev)
        self.check_cancel()  # honour the watchdog
        w = torch.linalg.eigvalsh(a).cpu()
        return {"n": n, "seed": seed,
                "lambda_max": float(w[-1]), "lambda_min": float(w[0])}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the tasks compute (cuda or cpu)")
    args = ap.parse_args()
    resolve_device(args.device)   # fail here, not in every task
    # one "cluster" (2 nodes x 2 cpus, simulated Slurm, queue kept full via
    # oversubscription) + one 2-slot workstation worker + monitor REST API
    with KsaCluster(prefix="demo", workers=1, worker_slots=2,
                    slurm=dict(nodes=2, cpus_per_node=2, oversubscribe=4),
                    task_timeout_s=30.0, http=True) as c:
        task_ids = [c.submit("matrix", params={"n": 96, "seed": s,
                                               "device": args.device},
                             cpus=1, timeout_s=60.0)
                    for s in range(12)]
        print(f"submitted {len(task_ids)} tasks; "
              f"monitor REST on :{c.http_port}")

        assert c.wait_all(task_ids, timeout=120.0), "tasks did not finish"
        for tid in task_ids[:3]:
            print(tid, "->", c.result(tid))

        with urllib.request.urlopen(
                f"http://127.0.0.1:{c.http_port}/summary") as r:
            print("REST /summary:", json.loads(r.read()))
        for a in c.status()["agents"]:
            print(f"{a['kind']} agent {a['agent_id']} completed:",
                  a["completed"])
    print("OK")


if __name__ == "__main__":
    main()
