"""driver.chunk_gap_ms: device milliseconds from a chunk's last replay to
the next chunk's first, the mean over the boundaries of a solve of ten
chunks, from the CUDA events the program records at each boundary with its
tracing on and no profiler (program_trace.py): the idle between chunks
that the host's check and the next chunk's launch leave. None where the
program records no such events."""

from portbench import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.chunk_gap_ms
