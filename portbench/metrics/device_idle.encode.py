"""device_idle.encode: the share of the traced stretch of encoding calls in
which no operation ran on the card (the union of the profiler's device
intervals against the stretch's wall time)."""


def read(run):
    tr = run.traced
    if run.kind != "encode" or tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
