"""Share of the training window in which no kernel, copy or memset ran on
the device: 1 - (the union of their intervals in the traced window, a
step, from the ``torch.profiler`` trace) / (the seconds a step took in the
measured, untraced window)."""

from portbench.core.readers import idle_pct

NAME, UNIT, SOURCE = "device_idle_pct.train", "%", "device_trace"


def read(run):
    return idle_pct(run)
