"""Share of the serving window in which no kernel, copy or memset ran on
the device: 1 - (the union of their intervals in the traced window, a
batch, from the ``torch.profiler`` trace) / (the seconds a batch took in the
measured, untraced window)."""

from portbench.core.readers import idle_pct

NAME, UNIT, SOURCE = "device_idle_pct.serve", "%", "device_trace"


def read(run):
    return idle_pct(run)
