"""projection.tri_products_per_it: the program's ``poly_tri_products``
counter (the triangle products, syrk and syrkx, of the poly filter's
one-triangle route) over one solve of one chunk with tracing off, over
its iterations, as program_trace.py counts sweeps and graph launches. It
says whether the route was taken: 40 where one f64 block takes it every
iteration (13 steps of three products and the last), 0 where no bucket
takes it. The count is fixed by the schedule, so one chunk reads it.
None where the program has no such counter."""

import importlib

from portbench import harness

COUNTER = "poly_tri_products"


def read(ctx):
    try:
        trace = importlib.import_module("cuadmm_tpu_torch.trace")
    except ImportError:
        return None
    counts = getattr(trace, "COUNTS", None)
    if not isinstance(counts, dict) or COUNTER not in counts:
        return None
    solver = getattr(ctx.program, "solver", None)
    chunk = int(solver.config.check_every) if solver is not None else harness.TRACE_ITER
    trace.disable()
    ctx.sync()
    before = counts[COUNTER]
    n = ctx.program.solve(min(chunk, int(ctx.workload["max_iter"])), ctx.stop_tol)["iterations"]
    return (counts[COUNTER] - before) / n
