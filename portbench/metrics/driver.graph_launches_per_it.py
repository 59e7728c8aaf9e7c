"""driver.graph_launches_per_it: the program's ``graph_launches`` counter
(CUDA graph parts the chunk runner launched) over one solve of
harness.TRACE_ITER iterations with tracing off, over its iterations
(program_trace.py): 1 where each iteration is one whole graph. None where
the program has no such counter."""

from portbench import program_trace


def read(ctx):
    pt = program_trace.get(ctx)
    return None if pt is None else pt.graph_launches_per_it
