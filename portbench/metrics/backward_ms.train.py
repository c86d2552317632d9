"""backward_ms.train: device milliseconds a training step under the
program's ``repro.backward`` range: everything ``autograd.grad`` launches,
on the caller's thread and on the autograd engine's device thread
(:mod:`portbench.spans`)."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "train", lambda n: n == "repro.backward")
