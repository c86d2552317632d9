"""attn_roofline.encode: flash attention's share of its roofline in the
traced encoding calls. The least time of the forward calls (yardstick
``attention_work``, bf16 operands, each call at one layer's shape) over the
device time of the work they launched, credited by the host op that
launched it: the program's autograd function of flash attention, whatever
kernels run inside it. Nothing is read where the stretch never entered
it."""
from portbench.yardstick import attention_work, least_seconds

FORWARD = "FlashAttentionFn"


def read(run):
    tr = run.traced
    shape = getattr(run.ref, "attention_shape", None)
    if run.kind != "encode" or tr is None or shape is None:
        return None
    fwd = tr.entry(FORWARD)
    if fwd is None:
        return None
    a = shape(run.spec, run.traffic["batch"], run.traffic["seq"])
    return 100.0 * fwd[0] * least_seconds(attention_work(**a)) / fwd[1]
