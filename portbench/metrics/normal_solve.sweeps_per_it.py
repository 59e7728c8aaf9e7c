"""normal_solve.sweeps_per_it: the program's ``neq_sweeps`` counter (the
refinement sweeps of every normal solve, each reading the factor once)
over one solve of harness.TRACE_ITER iterations with tracing off, over
its iterations (program_trace.py). None where the program has no such
counter."""

from portbench import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.sweeps_per_it
