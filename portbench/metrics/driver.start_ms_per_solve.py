"""driver.start_ms_per_solve: host milliseconds of the program's
``solve.start`` span (the solve's set-up before its first chunk: the
initial state's host products and uploads, the step), the mean over three
solves of one chunk with the program's tracing on and no profiler
(program_trace.py). None where the program has no such span."""

from portbench import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.start_ms
