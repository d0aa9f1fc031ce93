"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): the yardstick of every roofline and MFU share."""

BF16_FLOPS = 989e12  # tensor cores, bf16 in, fp32 accumulate
HBM_BYTES_PER_S = 3.35e12


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory peak, whichever is longer."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
