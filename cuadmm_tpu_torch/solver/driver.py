"""SDPSolver: the user-facing solve driver, and solve_escalated.

Port of cuadmm_tpu/solver/driver.py for float64 and float32 state, every
normal solver, and one device or a rank mesh. The iteration runs in chunks of
``config.check_every`` steps between host-side convergence checks; a chunk
queues its work on the device and its info rows come back in one copy at
the chunk's end. A chunk runs through the chunk runner (solver/step.py):
on CUDA one replayed CUDA graph an iteration (split at each eigh bucket),
on the CPU its plain replay; cg, host and any mesh run it eagerly
(``step.eager_reason``). ``SDPSolver.chunk_runner`` says which ran last:
"graphs", "plain" or "eager".

In float32 state the driver carries the JAX package's precision machinery:
an f64 copy of A's tables beside the f32 one (the normal solver's
refinement and CG read it), the true-residual probe at the convergence
boundary, the precision-stall detector (``precision_stall``) whose first
stall switches the step to f64 primal residuals (``rp_hp``) and whose
second ends the solve, and ``solve_escalated``, an f32 solve with an f64
tail.

Over a rank mesh (``mesh=``, parallel/mesh.py) every rank of the mesh
constructs the same SDPSolver and calls the same methods: the projection's
buckets and the ``sharded`` normal solver's factor are split over the
ranks, the rest runs whole on each, and the info rows, decisions and
results are the same on every rank. Only rank 0 prints.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, List, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.device import resolve_device, synchronize
from cuadmm_tpu_torch.ops import chol as chol_ops
from cuadmm_tpu_torch.ops import sparse as sparse_ops
from cuadmm_tpu_torch.ops.dispatch import choose_methods
from cuadmm_tpu_torch.ops.sparse import spmv_a
from cuadmm_tpu_torch.ops.svec import device_maps, pool_from_svec, svec_from_pool
from cuadmm_tpu_torch.parallel.mesh import Mesh, mesh_device
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver import scaling as scaling_mod
from cuadmm_tpu_torch.solver.state import INFO_FIELDS, SolveParams, SolverState
from cuadmm_tpu_torch.solver.step import ChunkRunners, make_step
from cuadmm_tpu_torch.structure import BlockStructure
from cuadmm_tpu_torch.utils.logging import IterLogger


@dataclasses.dataclass
class SDPResult:
    """Solution + per-iteration history (the MEX info cell's contents;
    reference: MATLAB/cuadmm_MATLAB.cu:385-424)."""

    X: np.ndarray
    y: np.ndarray
    S: np.ndarray
    iterations: int
    converged: bool
    diverged: bool
    message: str
    pobj: float
    dobj: float
    errRp: float
    errRd: float
    relgap: float
    sig: float
    total_time: float
    info: Dict[str, np.ndarray]
    # Divergence auto-recovery restarts taken (0 = clean run).
    recoveries: int = 0


# Precision-stall detector (cuadmm_tpu/solver/driver.py:614-663): the
# checks in the KKT trail, and the share of its oldest entry the trail's
# best must beat to count as progress.
STALL_WINDOW = 10
STALL_GAIN = 0.98
# The tightest tolerance an f32 state certifies (cuadmm_tpu/solver/
# driver.py:785-788); solve_escalated takes the f32 phase no further.
F32_CERT_TOL = 1e-5


def precision_stall(trail: List[float], chunk_kkt: np.ndarray, last_row: np.ndarray, stop_tol: float) -> bool:
    """One check of the float32 precision-floor stall detector.

    Appends the chunk's best KKT (``chunk_kkt``, one per row) to ``trail``,
    keeps the last STALL_WINDOW entries, and returns True when the trail
    was already full, feasibility (errRp and errRd of the chunk's last info
    row) is below ``stop_tol``, and the trail's best KKT improved on its
    oldest by less than 2%: the f32 iterate is grinding on its precision
    floor.
    """
    trail.append(float(np.min(chunk_kkt)))
    if len(trail) <= STALL_WINDOW:
        return False
    del trail[:-STALL_WINDOW]
    return max(last_row[2], last_row[3]) < stop_tol and min(trail) > STALL_GAIN * trail[0]


def resolve_projection(config: SolverConfig, structure: BlockStructure, device: torch.device,
                       instances: int = 1, verbose: bool = False) -> Union[str, Dict[int, str]]:
    """The projection the step runs: "eigh" when ``config.eig_rank`` is set
    (it needs explicit eigenvalues); under "auto" the calibrated per-bucket
    dispatch from the committed sweep of the device's backend, each bucket
    at its blocks times ``instances`` (a batch's instances form one batch
    of each bucket), or "eigh" where no table exists (as the JAX driver
    does off a TPU); else ``config.projection``."""
    if config.eig_rank is not None:
        return "eigh"
    if config.projection != "auto":
        return config.projection
    per_bucket = choose_methods(
        [(bk.n, bk.count * instances) for bk in structure.buckets], device.type, config.dtype
    )
    if per_bucket is None and verbose:
        print(
            f"projection='auto': no calibration table for {device.type}/{config.dtype} "
            "(python -m cuadmm_tpu_torch.eig_sweep makes one); using 'eigh'"
        )
    return "eigh" if per_bucket is None else per_bucket


class SDPSolver:
    """sGS-ADMM solver for one problem on one device or a rank mesh.

    ``device`` defaults to "cuda" and is never replaced: a CUDA device that
    is absent raises (``device.resolve_device``, which also turns TF32 off).
    With a ``mesh`` (parallel/mesh.py::make_mesh) the device is the mesh's,
    and a ``device`` that names another raises. ``config.dtype`` is the
    state's dtype, "float64" or "float32".
    """

    def __init__(self, problem: Problem, config: SolverConfig = SolverConfig(), device=None,
                 mesh: Optional[Mesh] = None):
        self.problem = problem
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            device = mesh_device(mesh, device)
        self.device = resolve_device("cuda" if device is None else device)
        self.dtype = getattr(torch, config.dtype)
        # Over a mesh only rank 0 prints; every rank computes the same rows.
        self._verbose = config.verbose and (mesh is None or mesh.rank == 0)
        self._init()
        self._runners = ChunkRunners()

    @property
    def chunk_runner(self) -> Optional[str]:
        """How the last chunk ran: "graphs", "plain" or "eager"."""
        return self._runners.kind

    def _tensor(self, x) -> torch.Tensor:
        """A host array on the device in the state dtype (rounded once from f64)."""
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        return torch.as_tensor(np.asarray(x, dtype=np_dtype), device=self.device)

    # ------------------------------------------------------------------
    def _init(self) -> None:
        prob, cfg = self.problem, self.config
        t0 = time.perf_counter()
        self.init_breakdown: Dict[str, object] = {}
        # Each stage a span ``init.<stage>`` and its seconds, ending in a
        # device sync, in init_breakdown.
        with trace.span("init"), trace.Stages("init", self.init_breakdown, self.device) as stages:
            stages.begin("structure")
            # eig_rank needs explicit eigenvalues and per-block top-k, so it
            # forces eigh and no packing. pack_to=None means off away from a TPU
            # (cuadmm_tpu/solver/driver.py:101-106).
            pack_to = 0 if cfg.pack_to is None or cfg.eig_rank is not None else cfg.pack_to
            self.structure = BlockStructure(prob.blk, cfg.bucket_rounding, cfg.exact_above, pack_to)
            self._projection = resolve_projection(cfg, self.structure, self.device, verbose=self._verbose)
            if self.structure.vec_len != prob.vec_len:
                raise ValueError("block structure does not match problem vec_len")
            vec_len, con_num = prob.vec_len, prob.con_num
            stages.begin("scaling")

            # Row-normalize A (reference: src/solver.cu:79-80).
            normA, at_vals = sparse_ops.normalize_rows(
                prob.At_rows, prob.At_cols, prob.At_vals, con_num
            )
            self._A_host = sp.csr_matrix(
                (at_vals, (prob.At_cols, prob.At_rows)), shape=(con_num, vec_len)
            )
            # Scaling (reference: src/solver.cu:167-191).
            sc, b_s, C_s, X_s, y_s, S_s = scaling_mod.scale_problem(
                normA, prob.dense_b(), prob.dense_C(), prob.X0, prob.y0, prob.S0
            )
            self.scaling = sc
            self._b_scaled = b_s
            self._C_scaled = C_s
            self._initial_scaled = (X_s, y_s, S_s)
            stages.begin("ell_tables")

            # A's tables in f64 for the normal solver's refinement and CG, and in
            # f32 beside them for an f32 state's step: one host build.
            f64 = torch.float64
            tables = sparse_ops.build_sparse_a_pool(
                prob.At_rows, prob.At_cols, at_vals, con_num, self.structure,
                (f64,) if self.dtype == f64 else (f64, self.dtype), self.device,
            )
            sa_hp, sa = tables[0], tables[-1]
            self._sa_hp = sa_hp
            stages.begin("normal_solver")
            self._at_triplets = (prob.At_rows, prob.At_cols, at_vals)
            neq_timings: Dict[str, object] = {}
            neq = self._normal_solver(cfg.normal_solver, cfg.cg_max_iter, neq_timings)
            stages.begin("params")
            self.init_breakdown.update({f"neq.{k}": v for k, v in neq_timings.items()})
            self._maps = device_maps(self.structure, self.dtype, self.device)
            dev = self._tensor
            self.params = SolveParams(
                sparse_a=sa,
                maps=self._maps,
                neq=neq,
                b=dev(b_s),
                C=pool_from_svec(dev(C_s), self._maps),
                normA=dev(normA),
                bscale=dev(sc.bscale),
                Cscale=dev(sc.Cscale),
                objscale=dev(sc.objscale),
                norm_borg=dev(sc.norm_borg),
                norm_Corg=dev(sc.norm_Corg),
            )
            # f32 state: the f64 tables of the rp_hp step (make_step), b and
            # normA from their unrounded host copies.
            self._rp_hp = None
            if self.dtype != f64:
                as64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=self.device)
                self._rp_hp = (sa_hp, as64(b_s), as64(normA))
        self.init_time = time.perf_counter() - t0
        if self._verbose:
            print(f"init {self.init_time:.1f}s: {self.init_breakdown}")

    def _normal_solver(self, mode: str, cg_max_iter: int, timings=None, limits=None):
        """The normal solver on the f64 tables, under the card's ``limits``
        (None: ``card_limits`` of the device). In f32 state its calibrated
        sweep count need only reach clip(0.03 stop_tol, 1e-6, 1e-5): every
        sweep more reads the factor once more an iteration
        (cuadmm_tpu/solver/driver.py:233-241)."""
        cfg, prob = self.config, self.problem
        target = None if self.dtype == torch.float64 else float(np.clip(cfg.stop_tol * 0.03, 1e-6, 1e-5))
        return chol_ops.build_normal_solver(
            *self._at_triplets,
            prob.con_num,
            prob.vec_len,
            self._sa_hp,
            mode,
            self.dtype,
            self.device,
            dense_chol_max=cfg.dense_chol_max,
            precond_eps=cfg.precond_eps,
            applies=cfg.precond_applies,
            timings=timings,
            eps=cfg.aat_eps,
            cg_tol=cfg.cg_tol,
            cg_max_iter=cg_max_iter,
            cg_block_jacobi=cfg.cg_block_jacobi,
            cg_precond=cfg.cg_precond,
            fsai_cap=cfg.fsai_cap,
            fsai_pattern_power=cfg.fsai_pattern_power,
            calibrate_target=target,
            mesh=self.mesh,
            limits=limits,
        )

    def _true_errRp(self, X_pool: torch.Tensor) -> float:
        """errRp of the pool iterate ``X_pool`` through the f64 A-product,
        from the parameters as the state holds them (cuadmm_tpu/solver/
        driver.py:186-207)."""
        p, f64 = self.params, torch.float64
        r = p.b.to(f64) - spmv_a(self._sa_hp, X_pool.to(f64))
        return float(torch.linalg.norm(p.normA.to(f64) * r) * p.bscale.to(f64) / p.norm_borg.to(f64))

    # ------------------------------------------------------------------
    def _initial_state(
        self, X_s, y_s, S_s, sig: float, scaling=None, b_scaled=None, C_scaled=None
    ) -> SolverState:
        """Initial residuals in scaled space (reference: src/solver.cu:194-228
        and the re-entrant path :385-409). The overrides give the batched
        solver each instance's (scaling, b, C) without touching this
        solver's own."""
        sc = self.scaling if scaling is None else scaling
        b = self._b_scaled if b_scaled is None else b_scaled
        C = self._C_scaled if C_scaled is None else C_scaled
        A = self._A_host
        Rp = b - A @ X_s
        SmC = S_s - C
        Rd = A.T @ y_s + SmC
        errRp = float(np.linalg.norm(sc.normA * Rp) * sc.bscale / sc.norm_borg)
        errRd = float(np.linalg.norm(Rd) * sc.Cscale / sc.norm_Corg)
        pobj = float(C @ X_s * sc.objscale)
        dobj = float(b @ y_s * sc.objscale)
        relgap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
        dev = self._tensor
        pool = lambda x: pool_from_svec(dev(x), self._maps)
        pool_len = self.structure.pool_len
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=self.device)
        return SolverState(
            X=pool(X_s),
            y=dev(y_s),
            S=pool(S_s),
            SmC=pool(SmC),
            Rp=dev(Rp),
            sig=dev(sig),
            errRp=dev(errRp),
            errRd=dev(errRd),
            pobj=dev(pobj),
            dobj=dev(dobj),
            relgap=dev(relgap),
            maxfeas=dev(max(errRp, errRd)),
            prim_win=i32(0),
            dual_win=i32(0),
            it=i32(0),
            sig_stage_2=i32(self.config.sig_update_stage_2),
            sigscale=dev(self.config.sigscale),
            best_kkt=dev(np.inf),
            X_best=torch.zeros(pool_len, dtype=self.dtype, device=self.device),
            y_best=torch.zeros(np.shape(y_s), dtype=self.dtype, device=self.device),
            S_best=torch.zeros(pool_len, dtype=self.dtype, device=self.device),
        )

    def _recovery_restart(self, state: SolverState, level: int) -> SolverState:
        """Escalated numerics + restart iterate after a non-finite chunk.

        Level 1 adds two refinement sweeps to the normal solver in every mode
        that has sweeps (the JAX package skips banded, cuadmm_tpu/solver/
        driver.py:356, a defect not copied); ``solve`` also runs the eigh
        projection for a probation window, keeping ``rp_hp`` if it is on
        (the JAX driver drops it there, driver.py:523 and :580, a defect not
        copied). Level 2 rebuilds the normal solver as the factor-free CG
        with at least 800 steps a solve (driver.py:358-377), which bypasses
        a corrupted factor. The iterate restarts from the best finite
        iterate seen so far, else from the initial point.
        """
        cfg, prob = self.config, self.problem
        neq = self.params.neq
        if level == 1:
            if neq.has_sweeps:
                neq = dataclasses.replace(neq, applies=neq.applies + 2)
        else:
            neq = self._normal_solver("cg", max(cfg.cg_max_iter, 800))
        self.params = dataclasses.replace(self.params, neq=neq)
        X_s = y_s = S_s = None
        if np.isfinite(float(state.best_kkt)):
            X_s = svec_from_pool(state.X_best, self._maps).cpu().numpy()
            y_s = state.y_best.cpu().numpy()
            S_s = svec_from_pool(state.S_best, self._maps).cpu().numpy()
            if not (np.all(np.isfinite(X_s)) and np.all(np.isfinite(y_s)) and np.all(np.isfinite(S_s))):
                X_s = None  # best-iterate buffers were poisoned mid-update
        if X_s is None:
            X_s, y_s, S_s = self._initial_scaled
        sig = float(state.sig)
        if not np.isfinite(sig) or sig <= 0:
            sig = cfg.sig if prob.sig0 is None else float(prob.sig0)
        return self._initial_state(X_s, y_s, S_s, sig)

    # ------------------------------------------------------------------
    def solve(
        self,
        max_iter: Optional[int] = None,
        stop_tol: Optional[float] = None,
        X0: Optional[np.ndarray] = None,
        y0: Optional[np.ndarray] = None,
        S0: Optional[np.ndarray] = None,
        sig: Optional[float] = None,
    ) -> SDPResult:
        """Run the solver. Optional X0/y0/S0/sig are *unscaled* iterates,
        covering both warm starts and re-entrant calls (the reference's
        ``if_first=false`` path, src/solver.cu:385-409)."""
        with trace.span("solve"):
            return self._solve(max_iter, stop_tol, X0, y0, S0, sig)

    def _solve(self, max_iter, stop_tol, X0, y0, S0, sig) -> SDPResult:
        with trace.span("solve.start"):
            cfg = self.config
            max_iter = cfg.max_iter if max_iter is None else int(max_iter)
            stop_tol = cfg.stop_tol if stop_tol is None else float(stop_tol)
            if sig is None:
                sig = cfg.sig if self.problem.sig0 is None else float(self.problem.sig0)
            else:
                sig = float(sig)

            if X0 is not None or y0 is not None or S0 is not None:
                sc = self.scaling
                Xd, yd, Sd = self._initial_scaled
                X_s = Xd if X0 is None else np.asarray(X0, np.float64) / sc.bscale
                y_s = yd if y0 is None else np.asarray(y0, np.float64) * sc.normA / sc.Cscale
                S_s = Sd if S0 is None else np.asarray(S0, np.float64) / sc.Cscale
            else:
                X_s, y_s, S_s = self._initial_scaled

            state = self._initial_state(X_s, y_s, S_s, sig)
            it_host = 0  # iterations ``state`` has completed (see make_step)

            def mk_step(projection, rp_hp: bool):
                # The projection (the probation window below) and rp_hp (the
                # stall detector) are the only options that change within a
                # solve; both are passed every time, so neither change drops
                # the other.
                return make_step(
                    stop_tol=stop_tol,
                    switch_admm=cfg.switch_admm,
                    sig_update_threshold=cfg.sig_update_threshold,
                    sig_update_stage_1=cfg.sig_update_stage_1,
                    sig_min=cfg.sig_min,
                    sig_max=cfg.sig_max,
                    eig_rank=cfg.eig_rank,
                    projection=projection,
                    rp_hp=self._rp_hp if rp_hp else None,
                    mesh=self.mesh,
                )

            projection = self._projection
            rp_hp_on = False  # f64 primal residuals, engaged by a precision stall
            step = mk_step(projection, rp_hp_on)

            log = IterLogger(enabled=self._verbose)
            log.header(self.scaling.norm_Corg, self.scaling.norm_borg)
            log.row(0, state)

            info_rows = []
            t0 = time.perf_counter()
            it_done = 0
            chunk_idx = 0
            profiled = False
            diverged = False
            stalled = False
            kkt_trail: List[float] = []  # best KKT of each check (precision_stall)
            recoveries = 0
            converged = float(torch.maximum(state.maxfeas, state.relgap)) < stop_tol
            # After a divergence recovery the step runs the exact eigh projection
            # for a probation window of 5 checks, then the configured projection
            # comes back (cuadmm_tpu/solver/driver.py:516-524,580-583).
            eigh_until = -1
        while it_done < max_iter and not converged:
            if eigh_until >= 0 and it_done >= eigh_until:
                projection = self._projection
                step = mk_step(projection, rp_hp_on)
                eigh_until = -1
            chunk = min(cfg.check_every, max_iter - it_done)
            # Trace one steady-state chunk (the second; the first pays the
            # kernel build and library warm-up).
            profiling = cfg.profile_dir is not None and chunk_idx == 1
            with trace.span("solve.chunk"):
                if profiling:
                    prof = torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
                    )
                    with prof:
                        state, info = self._runners.run(step, state, self.params, it_host, chunk, self.mesh)
                        synchronize(self.device)
                    os.makedirs(cfg.profile_dir, exist_ok=True)
                    rank = "" if self.mesh is None else f".rank{self.mesh.rank}"
                    prof.export_chrome_trace(os.path.join(cfg.profile_dir, f"chunk1{rank}.trace.json"))
                    profiled = True
                else:
                    state, info = self._runners.run(step, state, self.params, it_host, chunk, self.mesh)
            it_host += chunk
            chunk_idx += 1
            with trace.span("solve.check"):
                info_np = info.cpu().numpy().astype(np.float64)  # (chunk, 8)
                kkt = np.maximum(np.maximum(info_np[:, 2], info_np[:, 3]), info_np[:, 4])
                # Divergence guard: a chunk must detect non-finite state itself
                # rather than run on through NaNs.
                bad = np.nonzero(~np.isfinite(kkt))[0]
                if bad.size:
                    keep = int(bad[0]) + 1
                    info_rows.append(info_np[:keep])
                    it_done += keep
                    if cfg.divergence_recovery and recoveries < 2:
                        recoveries += 1
                        if self._verbose:
                            print(
                                f"  [recovery {recoveries}] non-finite residuals at "
                                f"iteration {it_done}; restarting from best iterate "
                                "with escalated numerics (eigh projection, "
                                + ("+2 refinement sweeps)" if recoveries == 1 else "CG normal solver)")
                            )
                        state = self._recovery_restart(state, recoveries)
                        it_host = 0
                        projection = "eigh"
                        step = mk_step(projection, rp_hp_on)
                        eigh_until = it_done + 5 * cfg.check_every
                        continue
                    diverged = True
                    break
                hits = np.nonzero(kkt < stop_tol)[0]
                if hits.size:
                    converged = True
                    keep = int(hits[0]) + 1
                    info_np = info_np[:keep]
                    it_done += keep
                else:
                    it_done += chunk
                if not converged and stop_tol > 0.0 and self.dtype == torch.float32:
                    # An f32 errRp is a measurement floor, not the iterate's:
                    # when it alone blocks convergence (within 10x), take the
                    # true residual once and patch the last row with it
                    # (cuadmm_tpu/solver/driver.py:596-613).
                    last = info_np[-1]
                    if max(last[3], last[4]) < stop_tol <= last[2] < 10 * stop_tol:
                        rp_true = self._true_errRp(state.X)
                        if rp_true < stop_tol:
                            converged = True
                            info_np[-1, 2] = rp_true
                    if not converged and precision_stall(kkt_trail, kkt, info_np[-1], stop_tol):
                        if rp_hp_on:
                            stalled = True
                            info_rows.append(info_np)
                            log.maybe_row(it_done, info_np[-1], time.perf_counter() - t0)
                            break
                        # First stall: the f32 errRp has been biasing the sigma
                        # vote; keep iterating in f32 with f64 primal residuals.
                        rp_hp_on = True
                        step = mk_step(projection, rp_hp_on)
                        kkt_trail.clear()
                        if self._verbose:
                            print("  [precision] errRp floor stall: switching to f64 primal residuals")
                info_rows.append(info_np)
                log.maybe_row(it_done, info_np[-1], time.perf_counter() - t0)
        with trace.span("solve.finish"):
            total_time = time.perf_counter() - t0

            if cfg.profile_dir is not None and not profiled:
                warnings.warn(
                    "profile_dir was set but the solve finished within the first "
                    "chunk; no steady-state chunk was available to trace."
                )
            if diverged:
                message = (
                    "Solver ABORTED: non-finite residuals at iteration "
                    f"{it_done} (errRp/errRd/relgap contain NaN or Inf)"
                    + (f" after {recoveries} auto-recovery restart(s)" if recoveries else "")
                    + ". The iteration diverged -- try a smaller sig or a larger precond_eps."
                )
            elif converged:
                message = "Solver ended: converged."
            elif stalled:
                message = (
                    "Solver ended: stalled at the float32 precision floor "
                    "(feasibility below tolerance, KKT not improving); use "
                    "solve_escalated or dtype='float64' to close the gap"
                )
            else:
                message = "Solver ended: maximum iteration reached"

            # Restore best iterate after the ADMM switch
            # (reference: src/solver.cu:567-576).
            if it_done > cfg.switch_admm and np.isfinite(float(state.best_kkt)):
                X_fin, y_fin, S_fin = state.X_best, state.y_best, state.S_best
            else:
                X_fin, y_fin, S_fin = state.X, state.y, state.S
            X, y, S = scaling_mod.unscale_solution(
                self.scaling,
                svec_from_pool(X_fin, self._maps).cpu().numpy(),
                y_fin.cpu().numpy(),
                svec_from_pool(S_fin, self._maps).cpu().numpy(),
            )
            info_mat = (
                np.concatenate(info_rows, axis=0) if info_rows else np.empty((0, len(INFO_FIELDS)))
            )
            info = {name: info_mat[:, i] for i, name in enumerate(INFO_FIELDS)}
            info["iter_num"] = np.asarray(it_done)
            info["total_time"] = np.asarray(total_time)

            result = SDPResult(
                X=X,
                y=y,
                S=S,
                iterations=it_done,
                converged=converged,
                diverged=diverged,
                message=message,
                pobj=float(state.pobj),
                dobj=float(state.dobj),
                # Last recorded row wins over chunk-end state: the true-residual
                # probe patches it, and on early exit it is the hit iteration's
                # value. The done guard freezes the state at the hit row, and
                # the probe reads the chunk-end state, so errRd and relgap below
                # are the same iterate's.
                errRp=float(info_mat[-1, 2]) if info_mat.size else float(state.errRp),
                errRd=float(state.errRd),
                relgap=float(state.relgap),
                sig=float(state.sig),
                total_time=total_time,
                info=info,
                recoveries=recoveries,
            )
            log.footer(result)
            return result


def solve(problem: Problem, config: SolverConfig = SolverConfig(), device=None, mesh: Optional[Mesh] = None,
          **kw) -> SDPResult:
    """One-shot convenience wrapper."""
    return SDPSolver(problem, config, device=device, mesh=mesh).solve(**kw)


def solve_escalated(
    problem: Problem,
    config: SolverConfig = SolverConfig(),
    max_iter: Optional[int] = None,
    stop_tol: Optional[float] = None,
    device=None,
    mesh: Optional[Mesh] = None,
) -> SDPResult:
    """An f32 solve, then an f64 tail when the f32 precision floor blocks
    convergence (cuadmm_tpu/solver/driver.py:752-815).

    The tail runs when the f32 solve did not converge and either diverged
    (a fresh f64 solve) or hit its floor: feasibility met with only the gap
    open, or ``stop_tol`` <= F32_CERT_TOL, below what f32 state can
    certify (a warm start from the f32 result, with its sigma). The tail's
    result is returned with the iterations and solve times of both phases
    added; otherwise the f32 result.

    Below F32_CERT_TOL the f32 phase stops at F32_CERT_TOL. The JAX ladder
    runs it to ``stop_tol``, which an f32 state that neither diverges nor
    reaches feasibility never meets: it spends all of ``max_iter`` and
    leaves the f64 tail one iteration. That defect is not copied.

    ``mesh`` runs both phases over the rank mesh (cuadmm_tpu/solver/
    driver.py:757, 782, 801).
    """
    cfg32 = config.replace(dtype="float32")
    max_iter = cfg32.max_iter if max_iter is None else int(max_iter)
    stop_tol = cfg32.stop_tol if stop_tol is None else float(stop_tol)
    tol32 = max(stop_tol, F32_CERT_TOL)
    res = SDPSolver(problem, cfg32, device=device, mesh=mesh).solve(max_iter=max_iter, stop_tol=tol32)
    floor_hit = bool(np.isfinite(res.relgap)) and (
        max(res.errRp, res.errRd) < stop_tol or stop_tol <= F32_CERT_TOL
    )
    if (res.converged and tol32 == stop_tol) or not (floor_hit or res.diverged):
        return res
    s64 = SDPSolver(problem, config.replace(dtype="float64"), device=device, mesh=mesh)
    warm = {} if res.diverged else dict(X0=res.X, y0=res.y, S0=res.S, sig=res.sig)
    res64 = s64.solve(max_iter=max(max_iter - res.iterations, 1), stop_tol=stop_tol, **warm)
    return dataclasses.replace(
        res64,
        iterations=res.iterations + res64.iterations,
        total_time=res.total_time + res64.total_time,
    )
