"""projection.poly_gemms_per_it: the program's ``poly_gemm_products``
counter (the batched GEMMs of the poly filter's full-GEMM route, one a
product over a bucket) over one solve of one chunk with tracing off, over
its iterations, as projection.tri_products_per_it reads the other route's
counter. It is a reading of the route: 40 a bucket an iteration with the
f64 schedule (13 steps of three products and the last), 0 where no bucket
takes it; a change that moves a bucket off the route lowers it whether or
not it is faster. None where the program has no such counter."""

import importlib

from portbench import harness

COUNTER = "poly_gemm_products"


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
