"""The whole train step's share of the card's bf16 peak: three times the
analytic forward operations a clip (forward and backward), times the
measured window's clips/s, over 989 TFLOP/s."""

from portbench.core.readers import mfu_pct

NAME, UNIT, SOURCE = "train_mfu_pct", "%", "host_clock"


def read(run):
    return mfu_pct(run, 3)
