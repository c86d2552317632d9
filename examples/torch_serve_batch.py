"""Serving a small model with batched requests through the KSA broker on
the PyTorch port (``examples/serve_batch.py`` on ``repro_torch``): the
AlphaKnot-2.0 web-service pattern (paper §4) applied to LM inference.

``serve_request`` tasks declare ``gpus=1`` and land only on the
engine-owning (GPU-profiled) worker, while tokenize/post-process stages run
on the CPU pool. Part 2 runs the same workload as a pipeline DAG: tokenize
(fan-out) → generate (serve_request as a map stage) → post-process (join).
The engine runs on ``--device``; for replicated serving see
``ServeReplicaSet`` in ``repro_torch.serve`` and the reference example.

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.cluster import KsaCluster
from repro_torch.configs import smoke_config
from repro_torch.convert import resolve_device
from repro_torch.core import ResourceProfile
from repro_torch.models import init_params, model_spec
from repro_torch.serve import (ServeEngine, ServeRequestComputing,
                               serve_pipeline)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (cuda or cpu)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = smoke_config("stablelm_1_6b")
    params = init_params(model_spec(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         getattr(torch, cfg.dtype), dev)
    # attach the engine to the serving task class (one engine per process)
    ServeRequestComputing.engine = ServeEngine(cfg, params, n_slots=4,
                                               max_len=96, device=dev)

    with KsaCluster(prefix="srv", workers=1, default_partitions=2) as c:
        # the model-owning pool: one GPU-profiled slot, so generate tasks
        # queue here and never oversubscribe the single engine
        c.add_worker(slots=1, profile=ResourceProfile(cpus=2, gpus=1))

        rng = np.random.RandomState(0)
        reqs = [{"id": f"user{i}",
                 "prompt": [int(t) for t in rng.randint(0, cfg.vocab_size,
                                                        4 + i % 4)],
                 "max_new": 8}
                for i in range(8)]
        t0 = time.time()
        tid = c.submit("serve_request", params={"requests": reqs},
                       gpus=1, timeout_s=600.0)
        assert c.wait_all([tid], timeout=900.0)
        res = c.result(tid)
        dt = time.time() - t0
        print(f"served {len(res['results'])} requests in {dt:.1f}s "
              f"({res['tokens_per_s']:.1f} tok/s inside the engine)")
        for rid, toks in sorted(res["results"].items())[:4]:
            print(f"  {rid}: {toks}")

        # -- part 2: the same workload as a 3-stage pipeline ----------------
        texts = [{"id": f"pipe{i}", "text": f"fold protein number {i}",
                  "max_new": 6} for i in range(8)]
        spec = serve_pipeline(batch_size=4, vocab_size=cfg.vocab_size,
                              max_new=6)
        t0 = time.time()
        camp = c.run_campaign(spec, texts, timeout_s=900.0)
        agg = camp.final
        print(f"\npipeline served {agg['n_requests']} requests "
              f"({agg['total_tokens']} tokens) in {time.time()-t0:.1f}s via "
              f"{[s.name for s in spec.topological()]}")
        for rid, r in list(agg["responses"].items())[:4]:
            print(f"  {rid}: {r['tokens']}")
        assert agg["n_requests"] == len(texts)
    ServeRequestComputing.engine = None
    print("OK")


if __name__ == "__main__":
    main()
