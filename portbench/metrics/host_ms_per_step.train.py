"""Host milliseconds to enqueue one step of the trainer from
``tools/train_net.py::build_trainer`` (forward, backward, AdamW), with no
synchronise: the benchmark's host clock, mean over the measured window."""

from portbench.core.readers import host_ms

NAME, UNIT, SOURCE = "host_ms_per_step.train", "ms", "host_clock"


def read(run):
    return host_ms(run)
