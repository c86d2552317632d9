"""Toy sizes of the benchmark's configurations and mixes, for its tests on
the CPU: every width cut, every key the harness reads kept."""
from __future__ import annotations

import time

from portbench import harness

SPECS = {
    "mamba2-130m": dict(d_model=64, n_layer=2, vocab_size=300, d_state=16,
                        headdim=16, chunk_size=32),
    "hubert-xlarge": dict(hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=128,
                          conv_dim=[32]),
}
TRAFFIC = {
    "mamba2-130m.train_4k": dict(batch=4, seq=128, pool=4),
    "hubert-xlarge.train_crop": dict(batch=4, seq=48, pool=4),
    "hubert-xlarge.encode_32k": dict(batch=1, seq=96, pool=2),
    "hubert-xlarge.encode_short": dict(batch=4, seq=32, pool=3),
}


def tiny_run(workload: str, *, seed: int = 2**31 + 7, trace: bool = False,
             seconds: float = 0.2, device: str = "cpu") -> harness.Run:
    bench = harness.Bench()
    w = bench.workload(workload)
    spec = dict(bench.spec(w["config"]), **SPECS[w["config"]])
    traffic = dict(bench.traffic(w["traffic"]), **TRAFFIC[workload])
    return harness.make_run(bench, workload, seed, seconds, trace, device,
                            time.perf_counter(), spec=spec, traffic=traffic)
