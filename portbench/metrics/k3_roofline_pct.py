"""K3's share of its roofline: each call's bound (``counts/attention.py::k3``)
summed, over the device time of the kernels launched inside spans around
``ops/flash_attention.py::tome_frame_attention``, wrapped where
``models/motionformer.py``'s trajectory attention looks it up."""

from portbench.core.peaks import bound_seconds
from portbench.core.readers import grad_wanted, roofline_pct
from portbench.counts.attention import k3

NAME, UNIT, SOURCE = "k3_roofline_pct", "%", "device_trace"
SPAN = "pb.k3"
WRAPS = [("vtm_torch.models.motionformer", "tome_frame_attention")]


def bound(args, kwargs):
    q, k, v = args[:3]
    key_bias = args[3] if len(args) > 3 else kwargs.get("key_bias")
    frames = args[5] if len(args) > 5 else kwargs.get("frames", 8)
    b, h, n, d = q.shape
    return bound_seconds(*k3(b, h, n, d, frames, key_bias is not None, grad_wanted(q, k, v, key_bias),
                             q.element_size()))


def read(run):
    return roofline_pct(run, SPAN)
