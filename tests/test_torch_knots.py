"""The port's knot app against the JAX reference, on the CPU.

The numpy copies must equal the originals; the screen, the localization and
the flat ``knot_batch`` task must give the reference's results exactly; and
the assertions of ``tests/test_knots.py`` must hold on the port.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import knots as jknots
from repro.core import Broker as JBroker
from repro.core import MonitorAgent as JMonitor
from repro.core import Submitter as JSubmitter
from repro.core import WorkerAgent as JWorker
from repro_torch.apps import knots as tknots
from repro_torch.convert import tree_to_torch
from repro_torch.core import Broker, MonitorAgent, Submitter, WorkerAgent

COPIED = ["torus_knot", "figure8", "random_coil", "deep_knot",
          "synthesize_batch", "quality_score", "knot_core", "classify"]


@pytest.mark.parametrize("name", COPIED)
def test_numpy_copy_has_the_original_source(name):
    assert (inspect.getsource(getattr(tknots, name))
            == inspect.getsource(getattr(jknots, name)))


def test_numpy_copies_give_the_originals_output():
    assert tknots.WRITHE_KNOT_THRESHOLD == jknots.WRITHE_KNOT_THRESHOLD
    assert tknots.QUALITY_THRESHOLD == jknots.QUALITY_THRESHOLD
    ids = [0, 1, 2, 3, 17, 4094, 9_999_999, 10_000_003]
    for n in (48, 97):
        got, got_truth = tknots.synthesize_batch(ids, n)
        want, want_truth = jknots.synthesize_batch(ids, n)
        np.testing.assert_array_equal(got, want)
        assert got_truth == want_truth
    np.testing.assert_array_equal(tknots.quality_score(ids),
                                  jknots.quality_score(ids))
    np.testing.assert_array_equal(tknots.figure8(50, noise=0.1, seed=3),
                                  jknots.figure8(50, noise=0.1, seed=3))
    wmap = np.random.RandomState(0).randn(60, 60).astype(np.float32) * 0.05
    wmap = wmap + wmap.T
    for th in (0.5, 2.0, 50.0):
        assert (tknots.knot_core(wmap, threshold=th)
                == jknots.knot_core(wmap, threshold=th))
    assert tknots.classify(3.0) == jknots.classify(3.0) == "knotted"


@pytest.mark.parametrize("ids,n_points", [(list(range(48)), 96),
                                          (list(range(64)), 128)])
def test_screen_and_localize_match_reference(ids, n_points):
    kept, knotted, wr, acn = tknots._screen_batch(ids, n_points, False,
                                                  device="cpu")
    jkept, jknotted, jwr, jacn = jknots._screen_batch(ids, n_points, False)
    assert kept == jkept
    assert knotted == jknotted
    assert knotted
    assert wr.keys() == jwr.keys()
    for k in wr:
        assert wr[k] == pytest.approx(jwr[k], rel=1e-4)
    assert acn == pytest.approx(jacn, rel=1e-5)
    cores = tknots._localize_cores(knotted, n_points, False, lambda: None,
                                   device="cpu")
    jcores = jknots._localize_cores(knotted, n_points, False, lambda: None)
    assert cores == jcores
    assert cores


def test_screen_with_every_id_dropped():
    q = tknots.quality_score(list(range(200)))
    low = [i for i in range(200) if q[i] < tknots.QUALITY_THRESHOLD][:5]
    assert len(low) == 5
    assert tknots._screen_batch(low, 64, False, device="cpu") == \
        ([], [], {}, 0.0)


def _flat(broker_cls, sub_cls, mon_cls, worker_cls, params):
    broker = broker_cls(default_partitions=2)
    sub = sub_cls(broker, "kn")
    mon = mon_cls(broker, "kn", poll_interval_s=0.01).start()
    worker = worker_cls(broker, "kn", slots=1, poll_interval_s=0.01).start()
    try:
        tids = sub.submit_batches("knot_batch", list(range(24)),
                                  batch_size=12, params=params)
        assert mon.wait_all(tids, timeout=120.0)
        return [mon.task(t).result for t in tids]
    finally:
        worker.stop()
        mon.stop()
        broker.close()


def test_flat_knot_batch_matches_reference():
    params = {"n_points": 80, "stage2": True}
    got = _flat(Broker, Submitter, MonitorAgent, WorkerAgent,
                {**params, "device": "cpu"})
    want = _flat(JBroker, JSubmitter, JMonitor, JWorker, params)
    for g, w in zip(got, want):
        assert g["processed"] == w["processed"] == 12
        assert g["kept"] == w["kept"]
        assert g["knotted"] == w["knotted"]
        assert g["cores"] == w["cores"]
        assert g["mean_acn"] == pytest.approx(w["mean_acn"], rel=1e-5)


# -- the assertions of tests/test_knots.py, on the port -----------------------

def _wa(coords):
    return tknots.writhe_and_acn(torch.from_numpy(np.asarray(coords)))


def test_screen_separates_knots_from_coils():
    coords, truth = tknots.synthesize_batch(list(range(32)), n_points=128)
    wr, _, _ = _wa(coords)
    deep = []
    for w, t in zip(wr.numpy(), truth):
        if t in ("trefoil", "cinquefoil"):
            assert abs(w) >= tknots.WRITHE_KNOT_THRESHOLD, (t, w)
        elif t == "deep_trefoil":
            deep.append(abs(w))
        else:
            assert abs(w) < tknots.WRITHE_KNOT_THRESHOLD, (t, w)
    rate = np.mean([d >= tknots.WRITHE_KNOT_THRESHOLD for d in deep])
    assert rate >= 0.75, (rate, deep)


def test_figure8_is_writhe_blind():
    wr, _, _ = _wa(tknots.figure8(160)[None])
    assert abs(float(wr[0])) < tknots.WRITHE_KNOT_THRESHOLD


def test_knot_core_localizes_deep_knot():
    n, core_len = 192, 96
    _, _, wmap = _wa(tknots.deep_knot(n, core=core_len, seed=5)[None])
    core = tknots.knot_core(wmap.numpy()[0])
    assert core is not None
    a, b = core
    tail = (n - core_len) // 2
    overlap = max(0, min(b, tail + core_len) - max(a, tail))
    assert overlap > core_len * 0.7, (core, (tail, tail + core_len))
    assert (b - a) < n * 0.85


def test_unknot_has_no_core():
    _, _, wmap = _wa(tknots.random_coil(128, seed=11)[None])
    assert tknots.knot_core(wmap.numpy()[0]) is None


def test_writhe_and_acn_match_reference():
    coords, _ = tknots.synthesize_batch(list(range(8)), 72)
    wr, acn, w = _wa(coords)
    jwr, jacn, jw = jknots.writhe_and_acn(jnp.asarray(coords))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=6e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(wr.numpy(), np.asarray(jwr), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(acn.numpy(), np.asarray(jacn), rtol=1e-4)


# -- the converter -------------------------------------------------------------

def test_tree_to_torch_round_trips_a_param_tree():
    rng = np.random.RandomState(0)
    tree = {
        "embed": rng.randn(10, 4).astype(np.float32),
        "periods": [{"w": rng.randn(2, 4, 4).astype(np.float32),
                     "scale": np.ones(4, np.float32)}],
        "bf16": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
        "step": np.int32(7),
        "shape": (np.arange(3, dtype=np.int64), np.float32(0.5)),
    }
    out = tree_to_torch(tree, "cpu")
    assert out.keys() == tree.keys()
    assert isinstance(out["periods"], list) and isinstance(out["shape"], tuple)
    np.testing.assert_array_equal(out["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(out["periods"][0]["w"].numpy(),
                                  tree["periods"][0]["w"])
    assert out["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["bf16"].float().numpy(),
                                  np.asarray(tree["bf16"], np.float32))
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 7
    assert out["shape"][0].dtype == torch.int64
    out["embed"][0, 0] = 99.0          # a copy: the source is untouched
    assert tree["embed"][0, 0] != 99.0


def test_tree_to_torch_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tree_to_torch({"w": np.zeros(2)})
