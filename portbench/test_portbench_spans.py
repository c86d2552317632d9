"""The readers of the program's own ranges (``portbench/spans.py`` and the
seven ``metrics/*_ms.*.py``) against hand-built traces: device ms a step
or call under known entries; nothing where the range, the unit or the
trace is missing or the cell is of the other kind; a microbatched step
read per step (the calls of ``repro.train_step``), not per range opened."""
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.trace import Trace

TRAIN = {"forward_ms.train": "repro.forward",
         "backward_ms.train": "repro.backward",
         "optimizer_ms.train": "repro.optimizer"}
ENCODE = {"mixer_ms.encode": "repro.mixer", "ffn_ms.encode": "repro.ffn"}
KERNELS = {"repro.kernel.ssd_scan": [48, 0.030],
           "repro.kernel.ssd_scan_bwd": [48, 0.050],
           "repro.kernel.flash_attention": [96, 0.020]}


def _run(kind, under, traced=True):
    tr = Trace(window_s=1.0, busy_s=0.5, under=under) if traced else None
    return SimpleNamespace(kind=kind, traced=tr)


def _train_under(steps=2, phase_calls=1):
    return {"repro.train_step": [steps, 0.40],
            "repro.forward": [steps * phase_calls, 0.10],
            "repro.backward": [2 * steps * phase_calls, 0.24],
            "repro.optimizer": [steps, 0.06],
            "SSDScanFn": [48, 0.030], **KERNELS}


def _encode_under(calls=3):
    return {"repro.encode": [calls, 0.90],
            "repro.mixer": [48 * calls, 0.30],
            "repro.ffn": [48 * calls, 0.55], **KERNELS}


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_phase_per_step(name):
    under = _train_under()
    got = harness.reader(name)(_run("train", under))
    assert got == pytest.approx(1e3 * under[TRAIN[name]][1] / 2)


@pytest.mark.parametrize("name", sorted(ENCODE))
def test_encode_layer_per_call(name):
    under = _encode_under()
    got = harness.reader(name)(_run("encode", under))
    assert got == pytest.approx(1e3 * under[ENCODE[name]][1] / 3)


@pytest.mark.parametrize("kind,calls", [("train", 2), ("encode", 3)])
def test_kernel_labels_summed_per_unit(kind, calls):
    under = _train_under() if kind == "train" else _encode_under()
    got = harness.reader(f"kernel_ms.{kind}")(_run(kind, under))
    # every label, and nothing else (SSDScanFn holds the same time)
    assert got == pytest.approx(1e3 * 0.100 / calls)


@pytest.mark.parametrize("name", sorted(TRAIN) + ["kernel_ms.train"])
def test_microbatched_step_reads_per_step(name):
    """Four microbatches open each phase four times a step: the reading is
    still per step."""
    one, four = _train_under(), _train_under(phase_calls=4)
    read = harness.reader(name)
    assert read(_run("train", four)) == pytest.approx(
        read(_run("train", one)))


@pytest.mark.parametrize("name", sorted(TRAIN) + sorted(ENCODE)
                         + ["kernel_ms.train", "kernel_ms.encode"])
def test_nothing_without_the_range_the_unit_or_the_kind(name):
    kind = name.rsplit(".", 1)[1]
    under = _train_under() if kind == "train" else _encode_under()
    read = harness.reader(name)
    assert read(_run(kind, under)) > 0
    other = "encode" if kind == "train" else "train"
    assert read(_run(other, under)) is None
    assert read(_run(kind, under, traced=False)) is None
    unit = "repro.train_step" if kind == "train" else "repro.encode"
    assert read(_run(kind, {k: v for k, v in under.items()
                            if k != unit})) is None
    spans = {**TRAIN, **ENCODE}
    read_only = ([spans[name]] if name in spans
                 else [k for k in under if k.startswith("repro.kernel.")])
    assert read(_run(kind, {k: v for k, v in under.items()
                            if k not in read_only})) is None
    # the parent program: autograd functions and ops, no ranges at all
    assert read(_run(kind, {"SSDScanFn": [48, 0.03],
                            "aten::mm": [10, 0.2]})) is None
