"""mfu.encode: the encoding calls' share of the card's bf16 peak. The
model's operations a call (the reference module's ``model_ops``, forward
only: weight products at 2 a weight a position, and attention's products)
times the calls of the window, over the window's wall time (the untraced
window of the same run) and over 989 TFLOP/s."""
from portbench.yardstick import BF16_FLOP_S


def read(run):
    if run.kind != "encode" or run.window_s <= 0:
        return None
    t = run.traffic
    ops = run.ref.model_ops(run.spec, t["batch"], t["seq"], train=False)
    return 100.0 * ops * run.units / run.window_s / BF16_FLOP_S
