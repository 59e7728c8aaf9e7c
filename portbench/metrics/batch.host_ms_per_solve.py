"""batch.host_ms_per_solve: host milliseconds of the program's
``batch.start`` span (the step and every instance's initial state,
stacked) and ``batch.finish`` span (every instance unscaled into its
result) of a solve, the mean over three solves of one chunk with the
program's tracing on and no profiler (batch_trace.py). None where the
program has no such spans."""

from portbench import batch_trace


def read(ctx):
    bt = batch_trace.get(ctx)
    return None if bt is None else bt.host_ms_per_solve
