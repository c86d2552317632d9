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

# the port's step spans (profiler ranges around the model code, which the
# reference has no use for): the helper, and where the docs name them
SPANS_DOC = """

Step spans — :func:`span`, profiler ranges inside the model code, which
record nothing unless ``torch.profiler`` runs around them:

- ``repro.train_step``: one train step; inside it ``repro.forward`` (the
  model and the loss), ``repro.backward`` (everything ``autograd.grad``
  launches, remat's recomputation included; on CUDA it is opened again on
  the autograd engine's device thread, which runs the backward's kernels)
  and ``repro.optimizer`` (learning rate, clipping, AdamW, the step count);
- ``repro.encode``: one encoder call (``make_prefill_step``);
- ``repro.mixer`` and ``repro.ffn``: each block's norm, mixing layer and
  residual add, and its second norm, MLP or MoE and add;
- ``repro.kernel.ssd_scan``, ``repro.kernel.ssd_scan_bwd``,
  ``repro.kernel.flash_attention``, ``repro.kernel.flash_attention_bwd``:
  the hand kernels' launches.

To see them, profile a few steps and open the trace in Perfetto or
``chrome://tracing``::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            state, metrics = train_step(state, batch)
        torch.cuda.synchronize()
    prof.export_chrome_trace("steps.json")

A kernel launched inside a range is linked to it by the profiler's
correlation id, so the device time under each range can be summed.
"""

TRACE_LEVELS_DOC = """

The port traces at two levels:

* task spans, in the :class:`SpanStore` above: the control plane's hops of
  each task, kept by the broker;
* step spans, as profiler ranges (:func:`span`): the train step's forward,
  backward and optimizer, the encoder call, each block's mixer and FFN, and
  the hand kernels' launches, named ``repro.<what>``. Nothing keeps them;
  they appear on ``torch.profiler``'s timeline for anyone who runs it around
  the program, and a kernel launched inside one is linked to it there.
"""

SPAN_HELPER = '''

_range = None


def span(name: str):
    """A profiler range named ``name``, as a context manager: a host op on
    ``torch.profiler``'s timeline, where the device work launched inside it
    is credited to it. It records no device event of its own (a
    ``record_function`` annotation does, which would count as busy device
    time) and costs well under a microsecond while no profiler runs. The
    range must close on the thread that opened it: one that ends on another
    thread is dropped from the profiler's tree. torch is imported on first
    use, so the control plane's import of this module stays torch-free."""
    global _range
    if _range is None:
        import torch
        _range = torch._C._profiler._RecordFunctionFast
    return _range(name)
'''

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
    "obs/__init__.py": [
        ("``BENCH_obs.json``).\n\"\"\"\n",
         "``BENCH_obs.json``)." + SPANS_DOC + "\"\"\"\n"),
        ("from .trace import NullSpanStore, SpanStore\n",
         "from .trace import NullSpanStore, SpanStore, span\n"),
        ('    "NullSpanStore",\n', '    "NullSpanStore",\n    "span",\n'),
    ],
    "obs/trace.py": [
        ("history is visible.\n\"\"\"\n",
         "history is visible." + TRACE_LEVELS_DOC + "\"\"\"\n"),
        ('__all__ = ["SpanStore", "NullSpanStore"]\n',
         '__all__ = ["SpanStore", "NullSpanStore", "span"]\n'),
        ('        return {"tasks": 0, "spans": 0, "evicted_tasks": 0,\n'
         '                "dropped_spans": 0}\n',
         '        return {"tasks": 0, "spans": 0, "evicted_tasks": 0,\n'
         '                "dropped_spans": 0}\n' + SPAN_HELPER),
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
