"""ssd_roofline.train: the SSD scan's share of its roofline in the traced
training steps. The least time of the scan's forward and backward calls
(yardstick ``ssd_fwd_work``, ``ssd_bwd_work`` at the configuration's chunk
of 256, bf16 operands, each call at one layer's shape) over the device time
of the work those calls launched. Device time is credited by the host op
that launched it: the entry points below are the program's autograd
function of the scan and its backward node, whatever kernels run inside
them. Nothing is read where the stretch never entered them."""
from portbench.yardstick import least_seconds, ssd_bwd_work, ssd_fwd_work

FORWARD = "SSDScanFn"
BACKWARD = "SSDScanFnBackward"


def read(run):
    tr = run.traced
    shape = getattr(run.ref, "ssd_shape", None)
    if run.kind != "train" or tr is None or shape is None:
        return None
    fwd, bwd = tr.entry(FORWARD), tr.entry(BACKWARD)
    if fwd is None or bwd is None:
        return None
    dims = shape(run.spec, run.traffic["batch"], run.traffic["seq"])
    least = (fwd[0] * least_seconds(ssd_fwd_work(*dims))
             + bwd[0] * least_seconds(ssd_bwd_work(*dims)))
    return 100.0 * least / (fwd[1] + bwd[1])
