"""SDPSolver: the user-facing solve driver.

Port of cuadmm_tpu/solver/driver.py for float64 state and the precond,
packed and banded normal solvers. The iteration runs in chunks of ``config.check_every``
steps between host-side convergence checks; a chunk queues its work on
the device and its info rows come back in one copy at the chunk's end.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.device import resolve_device, synchronize
from cuadmm_tpu_torch.ops import chol as chol_ops
from cuadmm_tpu_torch.ops import jacobi
from cuadmm_tpu_torch.ops import sparse as sparse_ops
from cuadmm_tpu_torch.ops.dispatch import bucket_method, choose_methods
from cuadmm_tpu_torch.ops.svec import device_maps, pool_from_svec, svec_from_pool
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver import scaling as scaling_mod
from cuadmm_tpu_torch.solver.state import INFO_FIELDS, SolveParams, SolverState
from cuadmm_tpu_torch.solver.step import make_step, run_chunk
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


class SDPSolver:
    """sGS-ADMM solver for one problem on one device.

    ``device`` defaults to "cuda" and is never replaced: a CUDA device that
    is absent raises (``device.resolve_device``, which also turns TF32 off).
    Float64 state only for now; ``dtype="float32"`` raises.
    """

    def __init__(self, problem: Problem, config: SolverConfig = SolverConfig(), device="cuda"):
        if config.dtype != "float64":
            raise NotImplementedError(
                "dtype='float32' is not ported yet (ROADMAP.md queue 1: "
                "'f32-state machinery and solve_escalated'); use dtype='float64'"
            )
        self.problem = problem
        self.config = config
        self.device = resolve_device(device)
        self.dtype = torch.float64
        self._init()

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=self.device)

    # ------------------------------------------------------------------
    def _init(self) -> None:
        prob, cfg = self.problem, self.config
        t0 = time.perf_counter()
        self.init_breakdown: Dict[str, object] = {}
        last = [t0]

        def mark(name: str) -> None:
            synchronize(self.device)
            now = time.perf_counter()
            self.init_breakdown[name] = round(now - last[0], 3)
            last[0] = now

        # eig_rank needs explicit eigenvalues and per-block top-k, so it
        # forces eigh and no packing. pack_to=None means off away from a TPU
        # (cuadmm_tpu/solver/driver.py:101-106).
        self._projection = "eigh" if cfg.eig_rank is not None else cfg.projection
        pack_to = 0 if cfg.pack_to is None or cfg.eig_rank is not None else cfg.pack_to
        self.structure = BlockStructure(prob.blk, cfg.bucket_rounding, cfg.exact_above, pack_to)
        if self._projection == "auto":
            # Calibrated per-bucket dispatch from the committed sweep of this
            # device's backend; without a table, eigh (as the JAX driver does
            # off a TPU).
            per_bucket = choose_methods(
                [(bk.n, bk.count) for bk in self.structure.buckets], self.device.type, "float64"
            )
            self._projection = "eigh" if per_bucket is None else per_bucket
            if per_bucket is None and cfg.verbose:
                print(
                    f"projection='auto': no calibration table for {self.device.type}/float64 "
                    "(python -m cuadmm_tpu_torch.eig_sweep makes one); using 'eigh'"
                )
        for i, bk in enumerate(self.structure.buckets):  # fail before the factorization
            if bucket_method(self._projection, i) == "jacobi":
                jacobi.check_size(bk.n)
        if self.structure.vec_len != prob.vec_len:
            raise ValueError("block structure does not match problem vec_len")
        vec_len, con_num = prob.vec_len, prob.con_num
        mark("structure")

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
        mark("scaling")

        sa = sparse_ops.build_sparse_a_pool(
            prob.At_rows, prob.At_cols, at_vals, con_num, self.structure, self.dtype, self.device
        )
        mark("ell_tables")
        neq_timings: Dict[str, object] = {}
        neq = chol_ops.build_normal_solver(
            prob.At_rows,
            prob.At_cols,
            at_vals,
            con_num,
            vec_len,
            sa,
            cfg.normal_solver,
            self.dtype,
            self.device,
            dense_chol_max=cfg.dense_chol_max,
            precond_eps=cfg.precond_eps,
            applies=cfg.precond_applies,
            timings=neq_timings,
        )
        mark("normal_solver")
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
        mark("params")
        self.init_time = time.perf_counter() - t0
        if cfg.verbose:
            print(f"init {self.init_time:.1f}s: {self.init_breakdown}")

    # ------------------------------------------------------------------
    def _initial_state(self, X_s, y_s, S_s, sig: float) -> SolverState:
        """Initial residuals in scaled space (reference: src/solver.cu:194-228
        and the re-entrant path :385-409)."""
        sc = self.scaling
        b, C, A = self._b_scaled, self._C_scaled, self._A_host
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

        Level 1 adds two refinement sweeps to the normal solver, whatever
        its mode (the JAX package skips banded, cuadmm_tpu/solver/driver.py:
        356, a defect not copied); ``solve`` also runs the eigh projection
        for a probation window. Level 2 swaps
        in the factor-free CG solver, which is not ported yet, so it raises.
        The iterate restarts from the best finite iterate seen so far, else
        from the initial point.
        """
        if level != 1:
            raise NotImplementedError(
                "divergence recovery level 2 rebuilds the normal solver as CG, "
                "which is not ported yet (ROADMAP.md queue 1: 'CG, FSAI, "
                "block-Jacobi and host modes')"
            )
        cfg, prob = self.config, self.problem
        neq = self.params.neq
        self.params = dataclasses.replace(
            self.params, neq=dataclasses.replace(neq, applies=neq.applies + 2)
        )
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

        def mk_step(projection):
            # The projection is the only option that changes within a solve
            # (the probation window below); every other option is fixed here,
            # so swapping the projection back drops nothing else.
            return make_step(
                stop_tol=stop_tol,
                switch_admm=cfg.switch_admm,
                sig_update_threshold=cfg.sig_update_threshold,
                sig_update_stage_1=cfg.sig_update_stage_1,
                sig_min=cfg.sig_min,
                sig_max=cfg.sig_max,
                eig_rank=cfg.eig_rank,
                projection=projection,
            )

        step = mk_step(self._projection)

        log = IterLogger(enabled=cfg.verbose)
        log.header(self.scaling.norm_Corg, self.scaling.norm_borg)
        log.row(0, state)

        info_rows = []
        t0 = time.perf_counter()
        it_done = 0
        chunk_idx = 0
        profiled = False
        diverged = False
        recoveries = 0
        converged = float(torch.maximum(state.maxfeas, state.relgap)) < stop_tol
        # After a divergence recovery the step runs the exact eigh projection
        # for a probation window of 5 checks, then the configured projection
        # comes back (cuadmm_tpu/solver/driver.py:516-524,580-583).
        eigh_until = -1
        while it_done < max_iter and not converged:
            if eigh_until >= 0 and it_done >= eigh_until:
                step = mk_step(self._projection)
                eigh_until = -1
            chunk = min(cfg.check_every, max_iter - it_done)
            # Trace one steady-state chunk (the second; the first pays the
            # kernel build and library warm-up).
            profiling = cfg.profile_dir is not None and chunk_idx == 1
            if profiling:
                prof = torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]
                    + ([torch.profiler.ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
                )
                with prof:
                    state, info = run_chunk(step, state, self.params, it_host, chunk)
                    synchronize(self.device)
                os.makedirs(cfg.profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(cfg.profile_dir, "chunk1.trace.json"))
                profiled = True
            else:
                state, info = run_chunk(step, state, self.params, it_host, chunk)
            it_host += chunk
            chunk_idx += 1
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
                    if cfg.verbose:
                        print(
                            f"  [recovery {recoveries}] non-finite residuals at "
                            f"iteration {it_done}; restarting from best iterate "
                            "with escalated numerics (eigh projection, +2 refinement sweeps)"
                        )
                    state = self._recovery_restart(state, recoveries)
                    it_host = 0
                    step = mk_step("eigh")
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
            info_rows.append(info_np)
            log.maybe_row(it_done, info_np[-1], time.perf_counter() - t0)
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
            # Last recorded row wins over chunk-end state: on early exit it
            # is the hit iteration's value.
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


def solve(problem: Problem, config: SolverConfig = SolverConfig(), device="cuda", **kw) -> SDPResult:
    """One-shot convenience wrapper."""
    return SDPSolver(problem, config, device=device).solve(**kw)
