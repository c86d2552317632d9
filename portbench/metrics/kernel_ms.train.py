"""kernel_ms.train: device milliseconds a training step under the
program's hand-kernel labels (every ``repro.kernel.*`` range: the SSD scan
and flash attention, forward and backward), wherever the model calls them
(:mod:`portbench.spans`)."""
from portbench.spans import KERNEL, device_ms


def read(run):
    return device_ms(run, "train", lambda n: n.startswith(KERNEL))
