"""encode_frames_per_s: frames encoded by the calls of the window over the
window's wall time, to the end of its last completed call (host clock,
synchronised)."""


def read(run):
    if run.kind != "encode" or run.window_s <= 0:
        return None
    return run.positions / run.window_s
