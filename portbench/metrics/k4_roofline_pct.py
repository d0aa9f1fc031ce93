"""K4's share of its roofline: each call's bound (``counts/attention.py::k4``,
from the forward's shapes) summed, over the device time of the kernels
launched inside spans around
``ops/flash_attention.py::tome_frame_attention_backward``, wrapped where
K3's autograd function looks it up."""

from portbench.core.peaks import bound_seconds
from portbench.core.readers import roofline_pct
from portbench.counts.attention import k4

NAME, UNIT, SOURCE = "k4_roofline_pct", "%", "device_trace"
SPAN = "pb.k4"
WRAPS = [("vtm_torch.ops.flash_attention", "tome_frame_attention_backward")]


def bound(args, kwargs):
    q, key_bias = args[0], args[3]
    frames = args[6] if len(args) > 6 else kwargs.get("frames", 8)
    dbias = key_bias is not None and kwargs.get("need_dbias", True)
    b, h, n, d = q.shape
    return bound_seconds(*k4(b, h, n, d, frames, key_bias is not None, dbias, q.element_size()))


def read(run):
    return roofline_pct(run, SPAN)
