"""ffn_ms.encode: device milliseconds an encoding call under the
program's ``repro.ffn`` ranges: each block's second norm, its MLP and the
residual add (:mod:`portbench.spans`)."""
from portbench.spans import device_ms


def read(run):
    return device_ms(run, "encode", lambda n: n == "repro.ffn")
