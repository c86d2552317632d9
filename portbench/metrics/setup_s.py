"""setup_s: seconds from the start of the run's process to the first timed
step or call (host clock): loading, weights and inputs drawn on the card,
kernels built or loaded, the step or call warmed up and, in a training
cell, its checked steps."""


def read(run):
    return run.setup_s
