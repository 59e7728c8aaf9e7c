"""One sGS-ADMM iteration and the chunk runner.

Port of cuadmm_tpu/solver/step.py. The algorithm and its constants follow
the reference solve loop (src/solver.cu:415-811):

  1. rhs = Rp/sig - A(S - C);  y_half = (AA^T)^{-1} rhs
  2. Rd1 = A^T y_half - C;  Xb = X + sig*Rd1;  S = (Pi(Xb) - Xb)/sig
  3. second normal-equation solve while in sGS mode (it < switch_admm);
     best-iterate tracking after the switch
  4. X += tau*sig*(Rd1 + S), tau = 1.95 (sGS) / 1.618 (ADMM)
  5. residuals, objectives, prim/dual vote, sigma re-balancing

A chunk of steps runs with no host sync of its own, so the done guard is a
device-side select over every state field.

The state may carry a leading instance axis (``parallel/batch.py``): vector
fields (B, length), scalars (B,), the parameters b and C per instance and
the scalings (B,). Reductions run over the last axis and per-instance
scalars broadcast through ``_col``; with no instance axis every op is the
one-instance op.

Over a rank mesh (``mesh``) the projection splits its buckets over the
ranks (ops/projection.py); everything else runs whole on every rank, on
identical inputs, so the ranks' states stay bitwise equal
(parallel/mesh.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.ops.projection import psd_project_pool
from cuadmm_tpu_torch.ops.sparse import SparseA, spmv_a, spmv_at
from cuadmm_tpu_torch.parallel.mesh import Mesh
from cuadmm_tpu_torch.solver.state import INFO_FIELDS, SolveParams, SolverState

TAU_SGS = 1.95  # reference: src/solver.cu:748
TAU_ADMM = 1.618  # reference: src/solver.cu:750
SWITCH_SIGSCALE_BOOST = 1.23  # reference: src/solver.cu:684
_SEG = 2048


def _seg_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis of per-segment partial sums, the
    partials reduced in f64. In f32 state this keeps the objectives free of
    a length-dependent accumulation floor (cuadmm_tpu/solver/step.py:167-
    180)."""
    n = u.shape[-1]
    k = -(-n // _SEG)
    pad = k * _SEG - n
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
        v = torch.nn.functional.pad(v, (0, pad))
    parts = torch.sum(u.reshape(u.shape[:-1] + (k, _SEG)) * v.reshape(v.shape[:-1] + (k, _SEG)), dim=-1)
    return torch.sum(parts.to(torch.float64), dim=-1)


def _col(t: torch.Tensor) -> torch.Tensor:
    """A per-instance scalar (B,) as a (B, 1) column against (B, length)
    fields; a 0-d scalar as it is."""
    return t.unsqueeze(-1) if t.dim() else t


def _select(cond: torch.Tensor, a: SolverState, b: SolverState, out: Optional[SolverState] = None) -> SolverState:
    """Field-wise ``torch.where(cond, a, b)``; ``cond`` per instance. With
    ``out`` each field is written into ``out``'s tensor (the same values)."""
    res = {}
    for f in dataclasses.fields(SolverState):
        x = getattr(a, f.name)
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        if out is None:
            res[f.name] = torch.where(c, x, getattr(b, f.name))
        else:
            res[f.name] = torch.where(c, x, getattr(b, f.name), out=getattr(out, f.name))
    return SolverState(**res)


def make_step(
    stop_tol: float,
    switch_admm: int,
    sig_update_threshold: int,
    sig_update_stage_1: int,
    sig_min: float,
    sig_max: float,
    eig_rank: Optional[int] = None,
    projection: Union[str, Dict[int, str]] = "eigh",
    rp_hp: Optional[Tuple[SparseA, torch.Tensor, torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
):
    """Build ``step(state, params, it_host, out=None, eigh=torch.linalg.eigh)
    -> (state, info_row)``.

    ``projection`` is one method for every bucket or the per-bucket dict of
    the calibrated dispatch; it goes to ``psd_project_pool`` unchanged.

    ``rp_hp``: optional (sparse_a_f64, b_f64, normA_f64). When given, Rp
    and errRp come from the f64 A-product of the iterate and Rp is then
    rounded to the state dtype (cuadmm_tpu/solver/step.py:60-85, 148-163):
    in f32 state the measured errRp floors near 1e-7 ||A|| ||X|| and biases
    the sigma vote, so the driver switches it on after a precision stall.

    ``mesh``: the rank mesh the projection's buckets are split over (None:
    one device). The pool vectors stay whole on every rank, where the JAX
    step places them on the mesh (cuadmm_tpu/solver/step.py:109-110, 145;
    parallel/mesh.py says why).

    ``it_host`` is the host's count of the iterations ``state`` has
    completed. It picks the sGS or ADMM branch on the host, where the JAX
    package has a device-side cond. That is exact: the count equals
    ``state.it`` until the done guard engages, and from then on the guard
    returns the old state whichever branch ran. ``step.in_sgs(it_host)``
    is that choice (the chunk runner keys its graphs on it).

    ``step.key`` is every argument of this call, tensors and the mesh by
    identity, and ``step.layers``, whether layer tracing was on
    (``trace.enable(layers=True)``): two steps with equal keys compute the
    same function and record the same graphs, so the chunk runner's cache
    replays one step's graphs for the other.

    The step opens its layers (``trace.layer``) at their outermost calls:
    "algebra" around all of it, and inside it "ell_products" around its
    own A and A^T products, "normal_solve" around each normal solve and
    "projection" around the projection. They are null contexts unless
    something traces them.

    ``out``: a state whose tensors receive the new state in place (the
    chunk runner's static buffers; ``out`` may be ``state`` itself, since
    the done guard's select is the step's last read of it). The values are
    those of the step without ``out``. ``eigh`` computes the "eigh"
    buckets' decompositions (the chunk runner runs them between graphs).
    """

    def in_sgs(it_host: int) -> bool:
        return it_host + 1 < switch_admm

    layer = trace.layer

    def step(state: SolverState, params: SolveParams, it_host: int, out: Optional[SolverState] = None,
             eigh: Callable = torch.linalg.eigh) -> Tuple[SolverState, torch.Tensor]:
        with layer(trace.STEP_LAYER):
            return _step(state, params, it_host, out, eigh)

    def _step(state, params, it_host, out, eigh):
        sa = params.sparse_a
        it = state.it + 1  # 1-based iteration number
        sig = state.sig
        sig_c = _col(sig)

        # -- Step 1: first normal-equation solve -------------------------
        with layer("ell_products"):
            a_smc = spmv_a(sa, state.SmC)
        rhsy = state.Rp / sig_c - a_smc
        del a_smc  # each product freed where the inline expression freed it: graphs hold no more
        with layer("normal_solve"):
            y_half = params.neq.solve(rhsy, warm=state.y)

        # -- Step 2: PSD projection --------------------------------------
        with layer("ell_products"):
            at_y = spmv_at(sa, y_half)
        Rd1 = at_y - params.C
        del at_y
        Xb = state.X + sig_c * Rd1
        with layer("projection"):
            Xproj = psd_project_pool(Xb, params.maps, eig_rank=eig_rank, method=projection, mesh=mesh, eigh=eigh)
        S = (Xproj - state.X) / sig_c - Rd1
        SmC = S - params.C

        # -- Step 3: sGS second solve / best tracking --------------------
        sgs = in_sgs(it_host)
        if sgs:
            with layer("ell_products"):
                a_smc = spmv_a(sa, SmC)
            rhsy2 = state.Rp / sig_c - a_smc
            del a_smc
            with layer("normal_solve"):
                y_new = params.neq.solve(rhsy2, warm=y_half)
            with layer("ell_products"):
                at_y = spmv_at(sa, y_new)
            Rd1_new = at_y - params.C
            del at_y
        else:
            y_new, Rd1_new = y_half, Rd1

        # Switch bookkeeping (reference: src/solver.cu:681-741); the KKT
        # metric compared is the previous iteration's, as in the reference.
        kkt_entry = torch.maximum(state.maxfeas, state.relgap)
        at_switch = it == switch_admm
        sig_stage_2 = torch.where(at_switch, state.sig_stage_2 // 2, state.sig_stage_2)
        sigscale = torch.where(at_switch, state.sigscale * SWITCH_SIGSCALE_BOOST, state.sigscale)
        take_best = at_switch | ((it > switch_admm) & (state.best_kkt > kkt_entry))
        best_kkt = torch.where(take_best, kkt_entry, state.best_kkt)
        take_best_c = _col(take_best)
        X_best = torch.where(take_best_c, state.X, state.X_best)
        y_best = torch.where(take_best_c, y_new, state.y_best)
        S_best = torch.where(take_best_c, S, state.S_best)

        # -- Step 4: primal update ---------------------------------------
        Rd = Rd1_new + S
        tau0 = TAU_SGS if sgs else TAU_ADMM
        tau = torch.where(
            state.errRd < stop_tol, sig.new_full((), max(TAU_ADMM, tau0 / 1.1)), tau0
        )
        X = state.X + _col(tau * sig) * Rd

        # -- Step 5: residuals, objectives, sigma ------------------------
        if rp_hp is not None:
            sa64, b64, normA64 = rp_hp
            X64 = X.to(b64.dtype)
            with layer("ell_products"):
                a_x = spmv_a(sa64, X64)
            del X64
            Rp64 = b64 - a_x
            del a_x
            Rp = Rp64.to(X.dtype)
            errRp = torch.linalg.norm(normA64 * Rp64, dim=-1).to(X.dtype) * params.bscale / params.norm_borg
        else:
            with layer("ell_products"):
                a_x = spmv_a(sa, X)
            Rp = params.b - a_x
            del a_x
            errRp = torch.linalg.norm(params.normA * Rp, dim=-1) * params.bscale / params.norm_borg
        errRd = torch.linalg.norm(Rd, dim=-1) * params.Cscale / params.norm_Corg
        pobj = (_seg_dot(params.C, X) * params.objscale).to(X.dtype)
        dobj = (_seg_dot(params.b, y_new) * params.objscale).to(X.dtype)
        maxfeas = torch.maximum(errRp, errRd)
        relgap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))

        prim_better = errRp / errRd < 1.0  # ratioconst = 1 (solver.cu:325)
        prim_win = state.prim_win + prim_better.to(torch.int32)
        dual_win = state.dual_win + (~prim_better).to(torch.int32)

        do_update = torch.where(
            it <= sig_update_threshold,
            it % sig_update_stage_1 == 1,
            it % sig_stage_2 == 1,
        )
        prim_dominates = prim_win > 1.2 * dual_win.to(torch.float64)
        dual_dominates = dual_win > 1.2 * prim_win.to(torch.float64)
        sig_up = do_update & prim_dominates
        sig_down = do_update & ~prim_dominates & dual_dominates
        sig_new = torch.where(sig_up, torch.clamp(sig * sigscale, max=sig_max), sig)
        sig_new = torch.where(sig_down, torch.clamp(sig / sigscale, min=sig_min), sig_new)
        prim_win = torch.where(sig_up, 0, prim_win)
        dual_win = torch.where(sig_down, 0, dual_win)

        new_state = SolverState(
            X=X,
            y=y_new,
            S=S,
            SmC=SmC,
            Rp=Rp,
            sig=sig_new,
            errRp=errRp,
            errRd=errRd,
            pobj=pobj,
            dobj=dobj,
            relgap=relgap,
            maxfeas=maxfeas,
            prim_win=prim_win,
            dual_win=dual_win,
            it=it,
            sig_stage_2=sig_stage_2,
            sigscale=sigscale,
            best_kkt=best_kkt,
            X_best=X_best,
            y_best=y_best,
            S_best=S_best,
        )
        done = torch.maximum(state.maxfeas, state.relgap) < stop_tol
        new_state = _select(done, state, new_state, out)
        info_row = torch.stack(
            [
                new_state.pobj,
                new_state.dobj,
                new_state.errRp,
                new_state.errRd,
                new_state.relgap,
                new_state.sig,
                params.bscale,
                params.Cscale,
            ],
            dim=-1,
        )
        return new_state, info_row

    step.in_sgs = in_sgs
    step.layers = trace.layers_on()
    step.key = (
        stop_tol, switch_admm, sig_update_threshold, sig_update_stage_1, sig_min, sig_max, eig_rank,
        tuple(sorted(projection.items())) if isinstance(projection, dict) else projection,
        None if rp_hp is None else tuple(id(t) for t in rp_hp),
        None if mesh is None else id(mesh),
        step.layers,
    )
    return step


def run_chunk(step, state: SolverState, params: SolveParams, it_host: int, chunk: int):
    """Run ``chunk`` steps from ``state`` (which has completed ``it_host``
    iterations), each op launched from the host; returns the new state and
    the (chunk, 8) info rows ((chunk, B, 8) for a batch), both still on the
    device. The eager counterpart of ``make_chunk_runner``."""
    rows = []
    for k in range(chunk):
        state, row = step(state, params, it_host + k)
        rows.append(row)
    return state, torch.stack(rows)


# ----------------------------------------------------------------------
# The chunk runner: one recorded iteration per branch, replayed.
# ----------------------------------------------------------------------


def eager_reason(params: SolveParams, mesh: Optional[Mesh]) -> Optional[str]:
    """Why a chunk must run eagerly (``run_chunk``), or None when the chunk
    runner can record it: a mesh's collectives (gloo) cannot be captured (a
    one-card NCCL world has one rank), and the normal solver says when a
    graph cannot hold its solve (``NormalEqSolver.eager_reason``: cg reads
    the host between its queued steps, host solves in numpy)."""
    if mesh is not None:
        return "mesh: collectives between ranks are not captured"
    return params.neq.eager_reason


@dataclasses.dataclass
class _EighSegment:
    """An eigh between two graphs: reads ``x`` (written by the graph before
    it) and writes the static ``w``, ``v`` (read by the graph after it), in
    eigh's own layout (``v`` batched column-major), so the graph after it
    sees the tensors an eager step sees."""

    x: Optional[torch.Tensor]
    w: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def outputs_for(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        w = x.new_empty(x.shape[:-1])
        v = x.new_empty(x.shape).mT  # each matrix column-major, as eigh returns it
        return w, v

    def run(self) -> None:
        torch.linalg.eigh(self.x, out=(self.w, self.v))
        trace.COUNTS["eigh_waits"] += 1

    replay = run  # between two graphs: eigh checks its status on the host, one wait a bucket


@dataclasses.dataclass
class _Recording:
    """One iteration of one (step, branch), recorded over the runner's
    static state. ``parts``: on CUDA the captured graphs, with an
    ``_EighSegment`` between two of them for each eigh bucket; on the CPU
    the eigh segments alone, which ``plain`` (the recorded step run on the
    static state) fills in order. ``tags``: with layer tracing, each
    part's span (``layer.<name>``), which its replay runs inside; else
    None. ``row``: the static info row a replay writes. ``counts``: what
    one replay adds to ``trace.COUNTS`` (the kernel launches and sweeps
    the capture counted, no wrapper running on a replay; the replay and
    its graph launches), which the runner adds once a chunk
    (``count``)."""

    parts: List[Union["torch.cuda.CUDAGraph", _EighSegment]] = dataclasses.field(default_factory=list)
    tags: Optional[List[str]] = None
    row: Optional[torch.Tensor] = None
    counts: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(graph_replays=1))
    plain: Optional[Callable[[], torch.Tensor]] = None

    def replay(self) -> None:
        if self.plain is not None:
            self.row = self.plain()
        elif self.tags is None:
            for part in self.parts:
                part.replay()
        else:
            for part, tag in zip(self.parts, self.tags):
                with trace.span(tag):
                    part.replay()

    def count(self, replays: int) -> None:
        """Add ``replays`` replays' counts."""
        trace.add(self.counts, replays)


_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for every runner's eager first
    iterations and captures: the library handles and the cuBLAS workspace
    that an eager iteration sets up on a stream are then set up once."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


def _clone(state: SolverState) -> SolverState:
    return SolverState(**{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(SolverState)})


class ChunkRunner:
    """``make_chunk_runner``'s runner: ``runner(state, it_host, chunk)``
    does what ``run_chunk(step, state, params, it_host, chunk)`` does, bit
    for bit, by replaying one recorded iteration per branch.

    The state lives in static buffers that the step updates in place
    (``out=``). The first iteration of each branch (``step.in_sgs``) runs
    eagerly on them as a real iteration, which builds every kernel, plan,
    work table and library handle; then that iteration is recorded: on
    CUDA captured into CUDA graphs (one, or one before, between and after
    each eigh bucket, whose eigh runs eagerly between replays), drawn from
    ``pool`` (a ``graph_pool_handle`` the solver's live graphs share); on
    the CPU kept as the step itself, the plain version. Every
    later iteration of that branch is one replay and one copy of its info
    row into the chunk's (chunk, 8) rows, so a chunk that crosses
    ``switch_admm`` or ends short needs no other recording. A capture that
    fails raises; nothing falls back to ``run_chunk``.

    The state returned is a copy: the next chunk's replays do not overwrite
    it. Passed back in, it is not copied again.
    """

    def __init__(self, step, params: SolveParams, pool=None):
        self.step, self.params = step, params
        self.device = params.b.device
        self.graphs = self.device.type == "cuda"
        self.pool = (pool if pool is not None else torch.cuda.graph_pool_handle()) if self.graphs else None
        self.stream = _capture_stream(self.device) if self.graphs else None
        self.recordings: Dict[bool, _Recording] = {}
        self.static: Optional[SolverState] = None
        self.capture_s = 0.0  # host seconds spent capturing (the eager iterations excluded)
        self._last: Optional[SolverState] = None

    @contextlib.contextmanager
    def _side_stream(self):
        """The capture stream, ordered after and before the current one (on
        the CPU, nothing)."""
        if not self.graphs:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            yield
        cur.wait_stream(self.stream)

    def _record(self, it_host: int) -> _Recording:
        rec = _Recording()
        step, params, static = self.step, self.params, self.static
        if not self.graphs:
            def eigh(x):  # the k-th eigh of a replay, into the k-th static outputs
                k = eigh.calls
                eigh.calls += 1
                if k == len(rec.parts):
                    rec.parts.append(_EighSegment(None, *_EighSegment.outputs_for(x)))
                seg = rec.parts[k]
                seg.x = x
                seg.run()
                return seg.w, seg.v

            def plain():
                eigh.calls = 0
                return step(static, params, it_host, out=static, eigh=eigh)[1]

            rec.plain = plain
            return rec
        t0 = time.perf_counter()
        before = trace.counts()
        torch.cuda.synchronize(self.device)
        if self.step.layers:
            rec.tags = []
        graph = [None]

        def add(part, layer: Optional[str]) -> None:
            rec.parts.append(part)
            if rec.tags is not None:
                rec.tags.append(f"layer.{layer}")

        def begin() -> None:
            graph[0] = torch.cuda.CUDAGraph()
            graph[0].capture_begin(pool=self.pool)

        def end(layer: Optional[str]) -> None:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                graph[0].capture_end()
            # Layer boundaries with no op between them (a normal solve and
            # the product after it) capture nothing: no part to launch.
            if not any("empty" in str(w.message) for w in caught):
                add(graph[0], layer)

        def eigh(x):  # end the graph, run eigh between replays, start the next
            end(trace.open_layer())
            seg = _EighSegment(x, *_EighSegment.outputs_for(x))
            add(seg, trace.open_layer())
            begin()
            return seg.w, seg.v

        def cut(layer: str) -> None:  # a layer boundary: end the layer's part, start the next
            end(layer)
            begin()

        with self._side_stream():
            begin()
            with trace.cutting(cut) if self.step.layers else contextlib.nullcontext():
                rec.row = step(static, params, it_host, out=static, eigh=eigh)[1]
            end(trace.STEP_LAYER)
        delta = {k: v - before[k] for k, v in trace.COUNTS.items() if v != before[k]}
        trace.add(delta, -1)  # nothing ran while capturing
        rec.counts = dict(delta, graph_replays=1,
                          graph_launches=sum(isinstance(p, torch.cuda.CUDAGraph) for p in rec.parts))
        torch.cuda.synchronize(self.device)
        self.capture_s += time.perf_counter() - t0
        return rec

    def __call__(self, state: SolverState, it_host: int, chunk: int):
        if self.static is None:
            self.static = _clone(state)
        elif state is not self._last:
            for f in dataclasses.fields(SolverState):
                getattr(self.static, f.name).copy_(getattr(state, f.name))
        static = self.static
        rows = torch.empty((chunk,) + tuple(static.sig.shape) + (len(INFO_FIELDS),),
                           dtype=static.sig.dtype, device=self.device)
        replays = [0, 0]  # by branch (in_sgs False, True)
        trace.chunk_edge("start", self.device)
        for k in range(chunk):
            branch = self.step.in_sgs(it_host + k)
            rec = self.recordings.get(branch)
            if rec is None:
                with trace.span("solve.capture"):
                    with self._side_stream():
                        rows[k] = self.step(static, self.params, it_host + k, out=static)[1]
                    self.recordings[branch] = self._record(it_host + k)
                trace.COUNTS["graph_captures"] += 1
                continue
            rec.replay()
            rows[k].copy_(rec.row)
            replays[branch] += 1
        trace.chunk_edge("end", self.device)
        for branch, n in enumerate(replays):
            if n:
                self.recordings[bool(branch)].count(n)
        self._last = _clone(static)
        return self._last, rows

    def free(self) -> None:
        """Drop the recordings (their graphs release the pool) and the
        static state."""
        self.recordings.clear()
        self.static = self._last = None


def make_chunk_runner(step, params: SolveParams, pool=None) -> ChunkRunner:
    """The counterpart of ``cuadmm_tpu.solver.step.make_chunk_runner``
    (``jax.jit`` of a ``lax.scan`` over ``chunk`` steps, state donated):
    a ``ChunkRunner`` over ``step`` and ``params``, whose graphs draw from
    ``pool`` (a ``torch.cuda.graph_pool_handle()``; a new one when None).
    The chunk length is an argument of each call."""
    return ChunkRunner(step, params, pool)


class ChunkRunners:
    """A solver's chunk runner cache, keyed as the JAX driver's ``_runner``
    (cuadmm_tpu/solver/driver.py:333-340) by stop_tol and the step (the
    runner keys its recordings on the branch): here by ``step.key``, which
    holds stop_tol and every other argument of ``make_step``, and by the
    parameters the graphs read. So a later solve whose step is made from
    the same arguments replays the recordings of an earlier one. The cache
    holds one runner: another key frees it, so one set of graphs is alive
    at a time, drawn from the solver's graph pool. ``kind`` says how the
    last chunk ran: "graphs" (CUDA), "plain" (the runner's CPU replay) or
    "eager" (``run_chunk``, for ``eager_reason``).
    """

    def __init__(self):
        self.runner: Optional[ChunkRunner] = None
        self._pool = None
        self.kind: Optional[str] = None
        self.reason: Optional[str] = None

    def run(self, step, state: SolverState, params: SolveParams, it_host: int, chunk: int,
            mesh: Optional[Mesh] = None):
        """``run_chunk(step, state, params, it_host, chunk)``, through the
        runner of ``step.key`` and ``params`` or eagerly."""
        self.reason = eager_reason(params, mesh)
        if self.reason is not None:
            self.kind = "eager"
            trace.chunk_edge("start", params.b.device)
            out = run_chunk(step, state, params, it_host, chunk)
            trace.chunk_edge("end", params.b.device)
            return out
        runner = self.runner
        if runner is None or runner.step.key != step.key or runner.params is not params:
            self.free()
            if params.b.device.type == "cuda" and self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            runner = self.runner = make_chunk_runner(step, params, self._pool)
        self.kind = "graphs" if runner.graphs else "plain"
        return runner(state, it_host, chunk)

    def free(self) -> None:
        """Free the runner's graphs. Their pool is not used again: the
        caching allocator keeps a pool whose graphs are all gone until its
        blocks are released, and refuses a new capture into it, so the
        next runner takes a new pool."""
        if self.runner is not None:
            self.runner.free()
            self.runner = self._pool = None
