"""mixer_ms.encode: device milliseconds an encoding call under the
program's ``repro.mixer`` ranges: each block's first norm, its mixing layer
(attention) and the residual add (:mod:`portbench.spans`)."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "encode", lambda n: n == "repro.mixer")
