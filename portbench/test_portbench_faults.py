"""The check catches what it is there to catch. Each case drives a whole run
of the harness (the look for a card skipped) with the timed path broken
underneath, and ``correct`` must come out false: a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, an answer altered where it is produced. The control, the reference
computed with fp8 products in the program's place, must fail the cell's
limits too; the sound program must pass them."""
import pytest
import torch

from portbench import harness
from portbench.check import encode_gaps, train_gaps, verdict
from portbench.drivers import encode, train
from portbench.reference.common import FP8
from portbench.tiny import tiny_run

TRAIN = ["mamba2-130m.train_4k", "hubert-xlarge.train_crop"]
ENCODE = ["hubert-xlarge.encode_32k", "hubert-xlarge.encode_short"]


def _broken_train_step(monkeypatch, fault):
    import repro_torch.train.step as step_mod
    real = step_mod.make_train_step

    def make(cfg, ocfg, **kw):
        step = real(cfg, ocfg, **kw)

        def broken(state, batch):
            if fault == "unchanged":
                _, metrics = step(state, batch)
                return state, metrics
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)
        return broken
    monkeypatch.setattr(step_mod, "make_train_step", make)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_is_not_correct(monkeypatch, workload, fault):
    _broken_train_step(monkeypatch, fault)
    out = harness.run_cell(tiny_run(workload, seconds=0.05))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", ENCODE)
def test_altered_answer_is_not_correct(monkeypatch, workload):
    import repro_torch.train.step as step_mod
    real = step_mod.make_prefill_step

    def make(cfg, **kw):
        call = real(cfg, **kw)

        def broken(params, batch):
            out = call(params, batch)
            out[0, 0] = out[0, 1]          # one position's answer replaced
            return out
        return broken
    monkeypatch.setattr(step_mod, "make_prefill_step", make)
    out = harness.run_cell(tiny_run(workload, seconds=0.05))
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_train_control_fails_and_program_passes(workload):
    run = tiny_run(workload)
    data = train.batches(run)
    n = run.traffic["check_steps"]
    _, _, prog = train.program_setup(run, data)
    ref = train.reference(run, data[:n])
    assert verdict(train_gaps(prog, ref), run.limits)[0]
    control = train.reference(run, data[:n], FP8)
    ok, checks = verdict(train_gaps(control, ref), run.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", ENCODE)
def test_encode_control_fails_and_program_passes(workload):
    run = tiny_run(workload)
    frames = encode.batches(run)[:1]
    call, params = encode.program(run)
    with torch.no_grad():
        got = call(params, {"embeds": frames[0]})
    want = encode.reference(run, frames)[0]
    units = encode.unit_logits
    assert verdict(encode_gaps(units(run, got), units(run, want)),
                   run.limits)[0]
    control = encode.reference(run, frames, FP8)[0]
    ok, checks = verdict(encode_gaps(units(run, control), units(run, want)),
                         run.limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", TRAIN + ENCODE)
def test_on_the_card_at_cell_size(cuda_device, workload):
    """The cell's own sizes on the card, one seed: the program within the
    limits; the control and each planted fault outside them."""
    import time

    from portbench import calibrate
    run = harness.make_run(harness.Bench(), workload, 2**31 + 11, 0.0,
                           False, cuda_device, time.perf_counter())
    fn = calibrate._train if run.kind == "train" else calibrate._encode
    readings = fn(run, control=True)
    assert verdict(readings.pop("program"), run.limits)[0]
    for name, gaps in readings.items():
        if not name.endswith("_detail"):
            assert not verdict(gaps, run.limits)[0], name
