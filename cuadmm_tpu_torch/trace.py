"""The port's tracing: one counter registry and named spans.

Counters. ``COUNTS`` holds every count the port keeps, as plain ints that
are always on:

  k1              fused_spd_apply launches (ops/precond_apply.py)
  k1_rhs          the right-hand sides those launches served (a batch's B, up to 8, a launch)
  k2              packed_solve launches (ops/tri_stream.py; one call queues both sweeps)
  k3              band_solve launches (ops/tri_stream.py; likewise): K3's tile forms
  k3_seg          band_segments_solve launches (ops/tri_stream.py): K3's segments
                  form, one launch an apply (forward and backward)
  k4              jacobi_eigh launches (ops/jacobi.py), every dtype
  k4_f32          jacobi_eigh's float32 launches among k4's
  cg_solves       cg normal solves (ops/chol.py)
  cg_steps        CG steps over those solves
  cg_waits        host reads of CG's convergence flag
  all_reduce      collectives through a Mesh (parallel/mesh.py)
  broadcast       likewise
  neq_sweeps      refinement sweeps of every normal solve (ops/chol.py)
  poly_tri_products  triangle products (syrk, syrkx) of the poly filter's
                  one-triangle route (ops/polyfilter.py), on any device
  poly_gemm_products  batched GEMMs (one matmul over a bucket) of the poly
                  filter's full-GEMM route (ops/polyfilter.py), on any device
  sym_mirror      mirror-kernel launches (ops/sym_products.py)
  ell             launches of the bucketed-ELL product kernel (ops/sparse.py):
                  one a product, two an aat_matvec
  graph_captures  recordings the chunk runner made (solver/step.py)
  graph_replays   replays of those recordings
  graph_launches  CUDA graph parts launched by those replays
  eigh_waits      eigh segments the chunk runner ran between two graph parts,
                  one host wait each on CUDA (the CPU's plain replay runs
                  the same segments), on any device

A kernel wrapper counts its launches on CUDA tensors only (its CPU
fallback counts nothing); ``poly_tri_products`` and ``poly_gemm_products``
count the routes' work, not launches, so on the CPU too, and ``eigh_waits``
likewise. A CUDA graph's kernels launch on replay, where no wrapper runs:
the chunk runner takes a capture's counts back and adds them, times the
replays, once a chunk.

Spans. ``span(name)`` marks a stretch of host time. With no torch profiler
active and tracing off it is a shared null context. Under a profiler it is
a ``torch.profiler.record_function``, so it sits in the device trace, on
its clock, beside the device ops the host launched inside it. After
``enable()`` it is also kept in memory as ``(name, parent, start_ns,
end_ns)`` on ``time.perf_counter_ns``; ``solve_record()`` returns the last
solve's spans and the device gaps between its chunks (``chunk_edge``).

Layers. ``layer(name)`` is a span ``layer.<name>`` that the step opens at
its outermost calls (solver/step.py): "algebra" around the whole step,
"normal_solve", "projection" and "ell_products" inside it. A layer opened
inside any layer but "algebra" does nothing. With ``enable(layers=True)``
the chunk runner cuts its CUDA graphs at each layer boundary
(``cutting``), tags each part with its layer and replays each part inside
that layer's span, so the profiler links a graph's kernels to the layer
through the part's graph launch.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

from cuadmm_tpu_torch.device import synchronize

COUNTS: Dict[str, int] = dict(
    k1=0, k1_rhs=0, k2=0, k3=0, k3_seg=0, k4=0, k4_f32=0,
    cg_solves=0, cg_steps=0, cg_waits=0,
    all_reduce=0, broadcast=0,
    neq_sweeps=0, poly_tri_products=0, poly_gemm_products=0, sym_mirror=0, ell=0,
    graph_captures=0, graph_replays=0, graph_launches=0, eigh_waits=0,
)


def add(delta: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign * delta`` to the counts."""
    for k, v in delta.items():
        COUNTS[k] += sign * v


def reset() -> None:
    """Set every count to 0."""
    COUNTS.update(dict.fromkeys(COUNTS, 0))


def counts() -> Dict[str, int]:
    """A copy of the counts."""
    return dict(COUNTS)


# ----------------------------------------------------------------------
# Spans
# ----------------------------------------------------------------------

STEP_LAYER = "algebra"  # the step's own layer, which the other layers open inside
_NULL = contextlib.nullcontext()
_RECORDING = False  # enable(): spans kept in memory
_LAYERS = False  # enable(layers=True): the chunk runner cuts its graphs at layer boundaries
_CUT: Optional[Callable[[str], None]] = None  # a capture's cut, while it records with layers
_LAYER: Optional[str] = None  # the open layer, while spans or cuts are live
_STACK: List[str] = []  # the names of the kept spans now open
_SPANS: List[Tuple[str, Optional[str], int, int]] = []  # the current root's kept spans
_EDGES: List[Tuple[str, object]] = []  # the current root's chunk edges
_LAST: Dict[str, dict] = {}  # root span name -> its spans and chunk edges


def enable(layers: bool = False) -> None:
    """Keep spans in memory; with ``layers``, also segment the chunk
    runner's graphs by layer (a step made after this call)."""
    global _RECORDING, _LAYERS
    _RECORDING, _LAYERS = True, bool(layers)


def disable() -> None:
    """Turn ``enable``'s tracing off (the kept records stay readable)."""
    global _RECORDING, _LAYERS
    _RECORDING = _LAYERS = False


def layers_on() -> bool:
    return _LAYERS


class _Span:
    __slots__ = ("name", "rf", "kept", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        # The kept span encloses the profiler's, whose start and end fall
        # inside record_function's own enter and exit.
        self.kept = _RECORDING
        if self.kept:
            if not _STACK:  # a root: a new record
                _SPANS.clear()
                _EDGES.clear()
            _STACK.append(self.name)
            self.start = time.perf_counter_ns()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.kept:
            end = time.perf_counter_ns()
            _STACK.pop()
            _SPANS.append((self.name, _STACK[-1] if _STACK else None, self.start, end))
            if not _STACK:
                _LAST[self.name] = dict(spans=list(_SPANS), edges=list(_EDGES))
        return False


def span(name: str):
    """A context manager marking ``name`` (see the module's docstring)."""
    if not (_RECORDING or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


class _Layer:
    __slots__ = ("name", "outer", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _LAYER
        self.outer = _LAYER
        if _CUT is not None and self.outer is not None:
            _CUT(self.outer)  # the outer layer's part ends here
        _LAYER = self.name
        self.span = span("layer." + self.name)
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        global _LAYER
        self.span.__exit__(*exc)
        if _CUT is not None and self.outer is not None:
            _CUT(self.name)
        _LAYER = self.outer
        return False


def layer(name: str):
    """The span ``layer.<name>`` at a layer's outermost call; nothing
    inside another layer than STEP_LAYER, or with nothing to trace."""
    if _LAYER is not None and _LAYER != STEP_LAYER:
        return _NULL
    if not (_RECORDING or _CUT is not None or _profiler._is_profiler_enabled):
        return _NULL
    return _Layer(name)


@contextlib.contextmanager
def cutting(cut: Callable[[str], None]):
    """While a capture records with layers: ``cut(layer)`` at each layer
    boundary ends the graph part that ``layer`` ran in."""
    global _CUT
    _CUT = cut
    try:
        yield
    finally:
        _CUT = None


def open_layer() -> Optional[str]:
    """The layer open now (None outside any traced layer)."""
    return _LAYER


def chunk_edge(kind: str, device: torch.device) -> None:
    """With tracing on, mark a chunk's ``"end"`` (after its last replay) or
    ``"start"`` (before its first): a CUDA timing event on the current
    stream, or on the CPU the host's clock."""
    if not _RECORDING:
        return
    if device.type == "cuda":
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
    else:
        mark = time.perf_counter_ns()
    _EDGES.append((kind, mark))


def _gaps_ms(edges) -> List[float]:
    """Milliseconds from each chunk's end to the next chunk's start."""
    out, end = [], None
    for kind, mark in edges:
        if kind == "end":
            end = mark
        elif end is not None:
            if isinstance(mark, int):
                out.append((mark - end) / 1e6)
            else:
                mark.synchronize()
                out.append(end.elapsed_time(mark))
            end = None
    return out


def solve_record(root: str = "solve") -> Optional[dict]:
    """The last ``root`` span's record since ``enable()``: ``spans``, a list
    of (name, parent, start_ns, end_ns) in the order they closed, and
    ``chunk_gaps_ms``, the device's time from each chunk's last replay to
    the next chunk's first (the host's on the CPU)."""
    rec = _LAST.get(root)
    if rec is None:
        return None
    return dict(spans=rec["spans"], chunk_gaps_ms=_gaps_ms(rec["edges"]))


# ----------------------------------------------------------------------
# Set-up stages
# ----------------------------------------------------------------------

_STAGES: List["Stages"] = []  # the set-ups now running, innermost last


class Stages:
    """Consecutive stages of a set-up, each a span ``<prefix>.<name>`` and
    its wall seconds, ending in a device sync, in ``out[name]`` (rounded to
    the ms). ``begin(name)`` ends the open stage and starts the next; the
    with-block's end ends the last. With ``builds``, the seconds of the
    kernel builds inside its stages (``building``) are left out of them
    and kept in ``out["build"]``, from 0."""

    def __init__(self, prefix: str, out: Optional[Dict[str, object]], device: torch.device,
                 builds: bool = False):
        self.prefix, self.out, self.device, self.builds = prefix, out, device, builds
        self.name: Optional[str] = None
        self.span = _NULL
        self.t = self.build_s = self.built_s = 0.0
        if builds and out is not None:
            out["build"] = 0.0

    def __enter__(self):
        _STAGES.append(self)
        self.t = time.perf_counter()
        return self

    def begin(self, name: Optional[str]) -> None:
        if self.name is not None:
            synchronize(self.device)
            now = time.perf_counter()
            if self.out is not None:
                self.out[self.name] = round(now - self.t - self.build_s, 3)
            self.t, self.build_s = now, 0.0
            self.span.__exit__(None, None, None)
        self.name = name
        if name is not None:
            self.span = span(f"{self.prefix}.{name}")
            self.span.__enter__()

    def __exit__(self, *exc):
        if exc[0] is None:
            self.begin(None)
        else:
            self.span.__exit__(*exc)
        _STAGES.remove(self)
        return False


@contextlib.contextmanager
def building():
    """A kernel build (nvcc and dlopen): inside the innermost running
    set-up that counts builds, the span ``<prefix>.build``, left out of
    its stage's seconds and added to its ``out["build"]``; elsewhere the
    span ``build``."""
    stages = next((st for st in reversed(_STAGES) if st.builds), None)
    t0 = time.perf_counter()
    with span("build" if stages is None else f"{stages.prefix}.build"):
        yield
    if stages is not None:
        dt = time.perf_counter() - t0
        stages.build_s += dt
        stages.built_s += dt
        if stages.out is not None:
            stages.out["build"] = round(stages.built_s, 3)
