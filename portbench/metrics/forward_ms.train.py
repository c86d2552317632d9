"""forward_ms.train: device milliseconds a training step under the
program's ``repro.forward`` range: the model's forward and the loss
(:mod:`portbench.spans`)."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "train", lambda n: n == "repro.forward")
