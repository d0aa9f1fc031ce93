"""The whole forward's share of the card's bf16 peak: the benchmark's
analytic operations a clip (``counts/<family>.py``, from the token schedule
it works out itself) times the measured window's clips/s, over 989 TFLOP/s."""

from portbench.core.readers import mfu_pct

NAME, UNIT, SOURCE = "serve_mfu_pct", "%", "host_clock"


def read(run):
    return mfu_pct(run, 1)
