"""train_tokens_per_s: positions trained by the steps of the window over
the window's wall time, to the end of its last completed step (host clock,
synchronised). For an encoder of frames a position is a frame."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.positions / run.window_s
