"""attn_roofline.train: flash attention's share of its roofline in the
traced training steps. The least time of the forward and backward calls
(yardstick ``attention_work``, bf16 operands, each call at one layer's
shape) over the device time of the work those calls launched, credited by
the host op that launched it: the program's autograd function of flash
attention and its backward node, whatever kernels run inside them. Nothing
is read where the stretch never entered them."""
from portbench.yardstick import attention_work, least_seconds

FORWARD = "FlashAttentionFn"
BACKWARD = "FlashAttentionFnBackward"


def read(run):
    tr = run.traced
    shape = getattr(run.ref, "attention_shape", None)
    if run.kind != "train" or tr is None or shape is None:
        return None
    fwd, bwd = tr.entry(FORWARD), tr.entry(BACKWARD)
    if fwd is None or bwd is None:
        return None
    a = shape(run.spec, run.traffic["batch"], run.traffic["seq"])
    least = (fwd[0] * least_seconds(attention_work(**a))
             + bwd[0] * least_seconds(attention_work(**a, backward=True)))
    return 100.0 * least / (fwd[1] + bwd[1])
