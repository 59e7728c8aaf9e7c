"""The batch's own counters and spans, read once a run for the per-layer
metrics ``batch.*`` (``metrics/batch.*.py``).

``get(ctx)`` runs, once and memoised on the readers' ``ctx``, on the cell's
program (a ``BatchedSDPSolver`` behind ``ctx.program.solver``) after the
harness's trace:

1. the counters (``cuadmm_tpu_torch.trace.COUNTS``) over one solve of one
   chunk with tracing off: the right-hand sides K1's launches served over
   its launches (``k1_rhs`` / ``k1``), and the eigh segments the chunk
   runner ran between graph parts an instance-iteration (``eigh_waits``);
2. ``trace.enable()``, no profiler: the host milliseconds of the
   ``batch.start`` and ``batch.finish`` spans of START_SOLVES solves of one
   chunk, their mean.

Then ``trace.disable()``. A program without ``cuadmm_tpu_torch.trace``
(program_trace.py's test) gives None; each number is None where the
program lacks its counter or span (an older checkout), or where no K1
launch ran.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

from portbench import harness, program_trace

START_SOLVES = 3
HOST_SPANS = ("batch.start", "batch.finish")


def get(ctx) -> Optional[SimpleNamespace]:
    """The batch's counts and spans of this run (see the module's docstring),
    or None where the program has no trace module or no solver."""
    if not hasattr(ctx, "batch_trace"):
        ctx.batch_trace = _run(ctx)
    return ctx.batch_trace


def _run(ctx) -> Optional[SimpleNamespace]:
    trace = program_trace._program_trace()
    solver = getattr(ctx.program, "solver", None)
    if trace is None or solver is None:
        return None
    counts = trace.COUNTS
    chunk = min(int(solver.config.check_every), int(ctx.workload["max_iter"]))
    solve = lambda: ctx.program.solve(chunk, ctx.stop_tol)["iterations"]
    out = SimpleNamespace(k1_rhs_per_launch=None, eigh_waits_per_it=None, host_ms_per_solve=None)
    try:
        trace.disable()
        ctx.sync()
        before = dict(counts)
        n = solve()
        delta = {k: v - before.get(k, 0) for k, v in counts.items()}
        if "k1_rhs" in delta and delta.get("k1"):
            out.k1_rhs_per_launch = delta["k1_rhs"] / delta["k1"]
        if "eigh_waits" in delta:
            out.eigh_waits_per_it = delta["eigh_waits"] / n
        harness.note("batch counters", dict(iterations=n, **{k: v for k, v in delta.items() if v}))

        trace.enable()
        host = []
        for _ in range(START_SOLVES):
            solve()
            rec = trace.solve_record("batch")
            spans = [] if rec is None else [(e - s) / 1e6 for name, _, s, e in rec["spans"] if name in HOST_SPANS]
            if len(spans) == len(HOST_SPANS):
                host.append(sum(spans))
        out.host_ms_per_solve = sum(host) / len(host) if len(host) == START_SOLVES else None
        harness.note("batch driver", dict(host_ms=host))
    finally:
        trace.disable()
    return out
