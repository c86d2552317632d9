"""What the per-layer metrics that read the program's own profiler ranges
share: the device time under the ranges a reader selects, in milliseconds
per training step or encoding call of the traced stretch.

The program opens its ranges with ``repro_torch.obs.trace.span``:
``repro.train_step`` around a step and ``repro.forward``,
``repro.backward``, ``repro.optimizer`` inside it; ``repro.encode`` around
an encoder call; ``repro.mixer`` and ``repro.ffn`` in each block; a
``repro.kernel.<name>`` label inside each hand kernel's launch. Device time
is credited as :mod:`portbench.trace` credits it, through the ops around
the launch on the launching thread (the backward's on the autograd engine's
device thread, where the program opens ``repro.backward`` again). A step or
call is one call of ``repro.train_step`` or ``repro.encode``, not of the
range read, which a microbatched step opens once a microbatch. A program
without the ranges gives nothing to read.
"""
from __future__ import annotations

from typing import Callable

UNIT = {"train": "repro.train_step", "encode": "repro.encode"}
KERNEL = "repro.kernel."


def device_ms(run, kind: str, select: Callable[[str], bool]) -> float | None:
    """Device ms a step or call under the ranges whose names ``select``
    takes (summed: no two of them nest), or None where the cell is not of
    ``kind``, was not traced, or ran no such range or unit."""
    tr = run.traced
    if run.kind != kind or tr is None:
        return None
    unit = tr.entry(UNIT[kind])
    got = [tr.entry(n) for n in tr.under if select(n)]
    got = [g for g in got if g is not None]
    if unit is None or not got:
        return None
    return 1e3 * sum(s for _, s in got) / unit[0]
