"""kernel_ms.encode: device milliseconds an encoding call under the
program's hand-kernel labels (every ``repro.kernel.*`` range: flash
attention's forward here) (:mod:`portbench.spans`)."""
from portbench.spans import KERNEL, device_ms


def read(run):
    return device_ms(run, "encode", lambda n: n.startswith(KERNEL))
