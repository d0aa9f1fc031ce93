"""Host milliseconds to enqueue one batch's forward (and its logits' copy),
before any synchronise: the benchmark's host clock around the call of the
forward that ``tools/model_benchmark.py`` and ``test_net`` run, mean over
the measured window. Near the batch's device time, the host paces the run."""

from portbench.core.readers import host_ms

NAME, UNIT, SOURCE = "host_ms_per_batch.serve", "ms", "host_clock"


def read(run):
    return host_ms(run)
