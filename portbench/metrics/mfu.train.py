"""mfu.train: the training steps' share of the card's bf16 peak. The
model's operations a step (the reference module's ``model_ops``: its weight
products at 6 a weight a position, and attention's products, from the
configuration's published sizes) times the steps of the window, over the
window's wall time (the untraced window of the same run, so that the
profiler's cost does not enter it) and over 989 TFLOP/s."""
from portbench.yardstick import BF16_FLOP_S


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    t = run.traffic
    ops = run.ref.model_ops(run.spec, t["batch"], t["seq"], train=True)
    return 100.0 * ops * run.units / run.window_s / BF16_FLOP_S
