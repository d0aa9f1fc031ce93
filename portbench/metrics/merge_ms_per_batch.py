"""Device milliseconds a batch spends merging: the kernels launched inside
a span around ``merge/policy.py::reduce_tokens`` (matching and the
size-weighted merge of ``merge/bipartite.py``), wrapped where the models
look it up, summed over the traced window and divided by its batches.
Nothing to read where no merge launched a kernel (r 0)."""

NAME, UNIT, SOURCE = "merge_ms_per_batch", "ms", "device_trace"
SPAN = "pb.reduce_tokens"
WRAPS = [("vtm_torch.models.videomae", "reduce_tokens"), ("vtm_torch.models.motionformer", "reduce_tokens")]


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.span_device_s(SPAN)
    return 1e3 * seconds / run.trace.iters if seconds > 0 else None
