"""K1's share of its roofline: each call's bound (``counts/attention.py::k1``
at the card's peaks) summed, over the device time of the kernels launched
inside spans around ``ops/flash_attention.py::tome_flash_attention``, wrapped
where ``models/common.py::attention_core`` looks it up."""

from portbench.core.peaks import bound_seconds
from portbench.core.readers import grad_wanted, roofline_pct
from portbench.counts.attention import k1

NAME, UNIT, SOURCE = "k1_roofline_pct", "%", "device_trace"
SPAN = "pb.k1"
WRAPS = [("vtm_torch.models.common", "tome_flash_attention")]


def bound(args, kwargs):
    q, k, v = args[:3]
    key_bias = args[3] if len(args) > 3 else kwargs.get("key_bias")
    b, h, n, d = q.shape
    return bound_seconds(*k1(b, h, n, d, key_bias is not None, grad_wanted(q, k, v, key_bias), q.element_size()))


def read(run):
    return roofline_pct(run, SPAN)
