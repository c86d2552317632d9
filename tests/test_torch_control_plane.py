"""The port's copy of the KSA control plane against its original.

Every module of ``repro.core``, ``repro.pipeline``, ``repro.autoscale``,
``repro.obs``, ``repro.federation`` and ``repro.cluster``, and the pure-Python
modules of the serving and training slices (``repro.models.config``,
``repro.configs``, ``repro.serve`` but its engine, ``repro.data``) are
copied verbatim into ``repro_torch`` with ``repro.`` renamed to ``repro_torch.`` and the
reference's issue numbers dropped from its comments (``rewrite``). Each copy
must equal its original after that rewrite, apart from the deliberate changes
declared in ``DELIBERATE`` — so the two cannot drift. Then one small knot
campaign runs through both packages' ``KsaCluster.run_campaign`` on the CPU
and must give the same results.
"""
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"

COPIED = [
    *(f"obs/{m}.py" for m in ("blackbox", "metrics", "rss", "series", "slo",
                              "telemetry", "trace", "__init__", "catalog")),
    *(f"core/{m}.py" for m in ("messages", "scheduling", "lease", "broker",
                               "computing", "simslurm", "submitter", "agents",
                               "monitor", "__init__")),
    *(f"pipeline/{m}.py" for m in ("spec", "status", "state", "agent",
                                   "driver", "__init__")),
    *(f"autoscale/{m}.py" for m in ("rate", "policy", "controller",
                                    "__init__")),
    "cluster.py",
    *(f"federation/{m}.py" for m in ("site", "router", "bridge", "spillover",
                                     "cluster", "__init__")),
    # pure-Python modules of the serving slice
    "models/config.py",
    *(f"configs/{m}.py" for m in ("__init__", "deepseek_v3_671b",
                                  "gemma3_1b", "gemma3_4b", "hubert_xlarge",
                                  "internlm2_1_8b", "internvl2_1b",
                                  "mamba2_130m", "moonshot_v1_16b_a3b",
                                  "recurrentgemma_2b", "stablelm_1_6b")),
    *(f"serve/{m}.py" for m in ("paged", "metrics", "replica", "__init__")),
    # numpy-only data stream of the training slice
    *(f"data/{m}.py" for m in ("synthetic", "__init__")),
]

# modules of the reference's serving slice that the port rewrites for torch
# (held to the reference by tests/test_torch_serve.py and
# tests/test_torch_models.py, not textually)
PORTED = {"serve/engine.py"}

# (original text, replacement) applied after the rename; each original text
# must occur in the reference, so a change there shows up here.
DELIBERATE = {
    # msgpack only for durable logs: an in-memory broker runs without it
    "core/broker.py": [
        ("import msgpack\n\n", ""),
        ("from .lease import ShardedLeaseTable\n",
         "from .lease import ShardedLeaseTable\n\n\n"
         "def _msgpack():\n"
         "    \"\"\"msgpack, imported only where the durable-log paths "
         "(``log_dir``)\n"
         "    use it, so an in-memory broker runs where msgpack is not "
         "installed.\"\"\"\n"
         "    import msgpack\n"
         "    return msgpack\n"),
        ("msgpack.packb(", "_msgpack().packb("),
        ("msgpack.unpackb(", "_msgpack().unpackb("),
    ],
}


def rewrite(text):
    """The mechanical part of the copy: rename the package, and drop the
    "(ISSUE n)" tags the reference's comments carry."""
    text = text.replace("repro.", "repro_torch.")
    text = re.sub(r"\(ISSUE \d+, ", "(", text)
    return re.sub(r" \(ISSUE \d+\)", "", text)


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_original(rel):
    want = rewrite((SRC / "repro" / rel).read_text())
    for old, new in DELIBERATE.get(rel, []):
        assert old in want, (rel, old)
        want = want.replace(old, new)
    got = (SRC / "repro_torch" / rel).read_text()
    assert got == want, f"src/repro_torch/{rel} drifted from src/repro/{rel}"


def test_every_control_plane_module_is_copied():
    """A module added to the reference's control plane must be copied (or
    left out on purpose here)."""
    left_out = set()
    for pkg in ("core", "pipeline", "autoscale", "obs", "federation",
                "configs", "serve", "data"):
        for f in sorted((SRC / "repro" / pkg).glob("*.py")):
            rel = f"{pkg}/{f.name}"
            assert rel in COPIED or rel in PORTED or rel in left_out, rel


def _campaign(cluster_cls, pipeline_fn, ids, **kw):
    with cluster_cls(workers=2, worker_slots=1, poll_interval_s=0.01) as c:
        res = c.run_campaign(pipeline_fn(12, n_points=64, **kw), ids,
                             timeout_s=240.0)
    assert res.status.state == "COMPLETED"
    return res.final


def test_campaign_matches_reference():
    from repro.apps import knots as jknots
    from repro.cluster import KsaCluster as JaxCluster
    from repro_torch.apps import knots as tknots
    from repro_torch.cluster import KsaCluster as TorchCluster

    ids = list(range(48))
    want = _campaign(JaxCluster, jknots.knots_pipeline, ids)
    got = _campaign(TorchCluster, tknots.knots_pipeline, ids, device="cpu")
    assert got["processed"] == want["processed"] == 48
    assert got["kept"] == want["kept"]
    assert got["batches"] == want["batches"] == 4
    assert got["knotted"] == want["knotted"]
    assert got["knotted"], "the population must have knots"
    assert got["cores"] == want["cores"]
    assert got["mean_acn"] == pytest.approx(want["mean_acn"], rel=1e-5)
