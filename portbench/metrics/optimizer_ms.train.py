"""optimizer_ms.train: device milliseconds a training step under the
program's ``repro.optimizer`` range: the learning rate, gradient clipping,
the AdamW update of every leaf and the step count (:mod:`portbench.spans`)."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "train", lambda n: n == "repro.optimizer")
