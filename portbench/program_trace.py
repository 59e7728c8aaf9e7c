"""The program's own spans and counters, read once a run for the per-layer
metrics that rest on them (``metrics/<name>.py`` of ``normal_solve``,
``projection``, ``ell_products``, ``algebra`` and ``driver``).

``get(ctx)`` runs, once and memoised on the readers' ``ctx``, on the cell's
program after the harness's trace:

1. the counters (``cuadmm_tpu_torch.trace.COUNTS``) over one solve of
   ``harness.TRACE_ITER`` iterations with tracing off: refinement sweeps and
   graph launches an iteration;
2. ``trace.enable()``, no profiler: the ``solve.start`` span of START_SOLVES
   solves of one chunk, then the device gap at each chunk boundary of a
   solve of GAP_CHUNKS chunks, from the program's chunk-boundary events;
3. ``trace.enable(layers=True)``: a warm solve of one chunk, which records
   the graphs cut at each layer boundary, then a ``TRACE_ITER``-iteration
   solve under torch.profiler. Each device op goes to the ``layer.<name>``
   span that encloses the host call that launched it, found by the trace's
   correlation id (a graph's kernels: the launch of the graph part, which
   the program replays inside its layer's span). Ops whose launch the
   trace lacks are ``unlinked``; ops launched outside every layer span
   (the chunk's copies, the check's read) are ``other``.

Then ``trace.disable()``. A program without ``cuadmm_tpu_torch.trace`` (an
older checkout) gives None, and so does each reader.
"""

from __future__ import annotations

import bisect
import importlib
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench import harness

LAYERS = ("normal_solve", "projection", "ell_products", "algebra")
START_SOLVES = 3
GAP_CHUNKS = 10
UNLINKED_MAX = 0.01  # a layer reader reads nothing past this share of the traced device time
RUNTIME = ("cuda_runtime", "cuda_driver")  # kineto's activity types of a host launch


def get(ctx) -> Optional[SimpleNamespace]:
    """The program's trace of this run (see the module's docstring), or None."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = _run(ctx)
    return ctx.program_trace


def layer_ms_per_it(ctx, layer: str) -> Optional[float]:
    """Device ms an iteration launched under ``layer.<layer>``, or None when
    there is no layered trace or its unlinked share passes UNLINKED_MAX."""
    pt = get(ctx)
    if pt is None or pt.layers is None or pt.layers["device_ms_per_it"] <= 0:
        return None
    if pt.layers["unlinked"] > UNLINKED_MAX * pt.layers["device_ms_per_it"]:
        return None
    return pt.layers[layer]


def _program_trace():
    try:
        trace = importlib.import_module("cuadmm_tpu_torch.trace")
    except ImportError:
        return None
    return trace if hasattr(trace, "solve_record") and hasattr(trace, "COUNTS") else None


def _span_ms(rec: dict, name: str) -> List[float]:
    return [(e - s) / 1e6 for n, _, s, e in rec["spans"] if n == name]


def _run(ctx) -> Optional[SimpleNamespace]:
    trace = _program_trace()
    solver = getattr(ctx.program, "solver", None)
    if trace is None or solver is None:
        return None
    chunk = int(solver.config.check_every)
    iters = min(harness.TRACE_ITER, int(ctx.workload["max_iter"]))
    solve = lambda n: ctx.program.solve(n, ctx.stop_tol)["iterations"]
    out = SimpleNamespace()
    try:
        trace.disable()
        ctx.sync()
        before = trace.counts()
        n = solve(iters)
        delta = {k: v - before[k] for k, v in trace.COUNTS.items()}
        out.sweeps_per_it = delta["neq_sweeps"] / n
        out.graph_launches_per_it = delta["graph_launches"] / n
        harness.note("program counters", dict(iterations=n, **{k: v for k, v in delta.items() if v}))

        trace.enable()
        starts = []
        for _ in range(START_SOLVES):
            solve(chunk)
            starts += _span_ms(trace.solve_record(), "solve.start")
        solve(GAP_CHUNKS * chunk)
        gaps = trace.solve_record()["chunk_gaps_ms"]
        out.start_ms = sum(starts) / len(starts)
        out.chunk_gap_ms = sum(gaps) / len(gaps) if gaps else None
        harness.note("program driver", dict(start_ms=starts, chunk_gap_ms=gaps))

        trace.enable(layers=True)
        solve(chunk)
        out.layers = _layered(ctx, trace, lambda: solve(iters))
    finally:
        trace.disable()
    return out


def _layered(ctx, trace, fn) -> Optional[Dict[str, float]]:
    """The traced solve's device ms an iteration by the layer that launched
    each op (see the module's docstring)."""
    act = torch.profiler.ProfilerActivity
    activities = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
    ctx.sync()
    with torch.profiler.profile(activities=activities) as prof:
        iters = fn()
        ctx.sync()
    device_ops, launches, spans = reduce_events(prof.events())
    ms = attribute(device_ops, launches, spans)
    per_it = {k: v / iters for k, v in ms.items()}
    per_it["device_ms_per_it"] = sum(ms.values()) / iters
    layers_sum = sum(per_it[k] for k in LAYERS)
    harness.note("program layers", dict(iterations=iters, device_ops=len(device_ops), launches=len(launches),
                                        **per_it, layers_sum=layers_sum,
                                        layers_share=layers_sum / per_it["device_ms_per_it"]
                                        if per_it["device_ms_per_it"] else None))
    return per_it if device_ops else None


def _is_launch(ev) -> bool:
    kind = getattr(ev, "activity_type", None)
    if kind:
        return str(kind).lower() in RUNTIME
    return ev.name.startswith(("cuda", "cu"))  # a torch whose events carry no activity type


def reduce_events(events) -> Tuple[list, list, list]:
    """From torch.profiler's events: the device ops (name, start_us, end_us,
    correlation id), the host launches (correlation id, start_us, end_us)
    and the layer spans (layer, start_us, end_us)."""
    device_ops, launches, spans = [], [], []
    for ev in events:
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device_ops.append((ev.name, s, e, ev.id))
        elif ev.name.startswith("layer."):
            spans.append((ev.name[len("layer."):], s, e))
        elif _is_launch(ev):
            launches.append((ev.id, s, e))
    return device_ops, launches, spans


def attribute(device_ops: Sequence[tuple], launches: Sequence[tuple], spans: Sequence[tuple]) -> Dict[str, float]:
    """Device milliseconds by layer: each op (name, start_us, end_us,
    correlation id) to the innermost span (layer, start_us, end_us) that
    holds the launch (correlation id, start_us, end_us) of the same id;
    "other" where no span holds it, "unlinked" where no launch has the
    id. Spans nest or are apart, as the program opens them."""
    spans = sorted(spans, key=lambda t: (t[1], -t[2]))
    starts = [s for _, s, _ in spans]
    layer_of: Dict[int, str] = {}
    for cid, s, e in launches:
        # The innermost span holding [s, e]: the latest-starting one that
        # starts at or before s and ends at or after e.
        i = bisect.bisect_right(starts, s) - 1
        name = "other"
        while i >= 0:
            lay, a, b = spans[i]
            if a <= s and e <= b:
                name = lay
                break
            i -= 1
        layer_of[cid] = name
    out = dict.fromkeys(LAYERS + ("other", "unlinked"), 0.0)
    for _, s, e, cid in device_ops:
        key = layer_of.get(cid, "unlinked")
        out[key] = out.get(key, 0.0) + (e - s) / 1e3
    return out
