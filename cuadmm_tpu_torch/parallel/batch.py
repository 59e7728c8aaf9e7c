"""Batched multi-instance solver: many SDPs sharing one structure and A.

Port of cuadmm_tpu/parallel/batch.py. The instances share the block
structure and the constraint matrix A and differ in b and C (a parametric
family: moment or SOS relaxations whose data enter only through b and C).
One base ``SDPSolver`` builds the structure, A's tables and the normal
solver's factor once; each instance has its own scaling. The whole batch
advances in lockstep, ``check_every`` iterations a chunk, through one step
whose state carries a leading instance axis (solver/step.py): the sparse
products gather on the last axis, each bucket's blocks of every instance go
to one eigh call, and the normal solve takes (B, con_num) right-hand sides
(one K1 launch per instance and sweep in precond and split). An instance
that converges is frozen by its own done guard and keeps its own
convergence iteration and ``SDPResult``.

The projection is resolved as ``SDPSolver`` resolves it
(``solver/driver.py::resolve_projection``): "eigh" when ``eig_rank`` is
set, and under "auto" the calibrated per-bucket dispatch at the batch's
own bucket sizes, each bucket's blocks times this rank's instances, which
the projection folds into one batch (K4 on max-cut's cliques on the card).
As in the JAX package there is no divergence recovery and no rp_hp;
``config.dtype`` sets the state dtype. Chunks run through the chunk runner
as ``SDPSolver``'s do (one CUDA graph an iteration on the card, split at
each "eigh" bucket; eager over a mesh or with cg or host);
``chunk_runner`` says which ran last.

Tracing (cuadmm_tpu_torch/trace.py): a solve is the root span ``batch``
with ``batch.start`` (the step and the stacked initial states),
``batch.chunk`` (each chunk), ``batch.check`` (the host's convergence
scan) and ``batch.finish`` (the unscaled results); ``trace.solve_record
("batch")`` returns them and the device gaps between chunks.

Over a rank mesh (``mesh=``, parallel/mesh.py) the instance axis is split
(cuadmm_tpu/parallel/batch.py:138-175): rank r solves its contiguous share
of the instances (``shard_bounds``) in lockstep with the others, its own
copy of the normal solver's factor serving them (K1 once per local
instance and sweep). The iteration itself needs no collective. After
each chunk one masked all_reduce gives every rank every instance's info
rows, so all ranks take the same stopping decision, and at the end one
more gives every rank every instance's result.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.ops.svec import pool_from_svec, svec_from_pool
from cuadmm_tpu_torch.parallel.mesh import Mesh, mesh_device, shard_bounds
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver import scaling as scaling_mod
from cuadmm_tpu_torch.solver.driver import SDPResult, SDPSolver, resolve_projection
from cuadmm_tpu_torch.solver.state import INFO_FIELDS, SolveParams, SolverState
from cuadmm_tpu_torch.solver.step import ChunkRunners, make_step


def _same_pattern(p0: Problem, p: Problem) -> bool:
    return (
        p0.blk == p.blk
        and p0.con_num == p.con_num
        and len(p0.At_vals) == len(p.At_vals)
        and np.array_equal(p0.At_rows, p.At_rows)
        and np.array_equal(p0.At_cols, p.At_cols)
        and np.allclose(p0.At_vals, p.At_vals)
    )


class BatchedSDPSolver:
    """Lockstep batch solver over instances sharing (blk, A), on one device
    or with the instances split over a rank mesh (``mesh``; the device is
    the mesh's, and every rank of it constructs the solver with the same
    problems). Each rank must get at least one instance.
    """

    def __init__(self, problems: List[Problem], config: SolverConfig = SolverConfig(),
                 mesh: Optional[Mesh] = None, device=None):
        if mesh is not None:
            device = mesh_device(mesh, device)
        if not problems:
            raise ValueError("empty problem batch")
        base = problems[0]
        for p in problems[1:]:
            if not _same_pattern(base, p):
                raise ValueError("batched solve requires identical blk and At across instances")
        self.problems = problems
        self.config = config
        self.mesh = mesh
        # This rank's instances [lo, hi).
        self._lo, self._hi = (0, len(problems)) if mesh is None else shard_bounds(len(problems), mesh)
        if self._hi <= self._lo:
            raise ValueError(f"{len(problems)} instances leave rank {mesh.rank} of {mesh.size} none")
        # The factor is built on every rank, for its own instances.
        self._base = SDPSolver(base, config, device=device)
        self.dtype = self._base.dtype
        self.device = self._base.device
        self._projection = resolve_projection(config, self._base.structure, self.device,
                                              instances=self._hi - self._lo)

        # Per-instance scaling; normA depends only on A, so it is shared.
        t0 = time.perf_counter()
        normA = self._base.scaling.normA
        self._scalings, b_list, C_list, self._init_list = [], [], [], []
        for p in problems[self._lo:self._hi]:
            sc, b_s, C_s, X_s, y_s, S_s = scaling_mod.scale_problem(
                normA, p.dense_b(), p.dense_C(), p.X0, p.y0, p.S0
            )
            self._scalings.append(sc)
            b_list.append(b_s)
            C_list.append(C_s)
            self._init_list.append((X_s, y_s, S_s))
        self._b_stack = np.stack(b_list)
        self._C_stack = np.stack(C_list)
        self._runners = ChunkRunners()

        bp, dev = self._base.params, self._base._tensor
        scal = lambda name: dev([getattr(sc, name) for sc in self._scalings])
        self.params = SolveParams(
            sparse_a=bp.sparse_a,
            maps=bp.maps,
            neq=bp.neq,
            b=dev(self._b_stack),
            C=torch.stack([pool_from_svec(dev(C), bp.maps) for C in self._C_stack]),
            normA=bp.normA,
            bscale=scal("bscale"),
            Cscale=scal("Cscale"),
            objscale=scal("objscale"),
            norm_borg=scal("norm_borg"),
            norm_Corg=scal("norm_Corg"),
        )
        # The base solver's set-up stages, and the instances' scaling and
        # upload after it (seconds).
        self.init_breakdown = dict(self._base.init_breakdown, instances=round(time.perf_counter() - t0, 3))

    @property
    def chunk_runner(self) -> Optional[str]:
        """How the last chunk ran: "graphs", "plain" or "eager"."""
        return self._runners.kind

    def _initial_states(self, sig: float) -> SolverState:
        states = [
            self._base._initial_state(X_s, y_s, S_s, sig, scaling=sc, b_scaled=self._b_stack[i],
                                      C_scaled=self._C_stack[i])
            for i, ((X_s, y_s, S_s), sc) in enumerate(zip(self._init_list, self._scalings))
        ]
        return SolverState(**{
            f.name: torch.stack([getattr(s, f.name) for s in states]) for f in dataclasses.fields(SolverState)
        })

    def _gather(self, local: torch.Tensor, dim: int) -> torch.Tensor:
        """Every instance's entries of ``local``, which holds this rank's
        instances along ``dim``, on every rank: one masked all_reduce over a
        mesh (an exact sum of one rank's part and zeros), ``local`` itself
        without one."""
        if self.mesh is None:
            return local
        shape = list(local.shape)
        shape[dim] = len(self.problems)
        full = local.new_zeros(shape)
        full.narrow(dim, self._lo, self._hi - self._lo).copy_(local)
        return self.mesh.all_reduce(full)

    def solve(self, max_iter: Optional[int] = None, stop_tol: Optional[float] = None,
              sig: Optional[float] = None) -> List[SDPResult]:
        """Run every instance from its own starting point; one SDPResult per
        instance, in order. The batch stops when every instance converged or
        at ``max_iter``."""
        with trace.span("batch"):
            return self._solve(max_iter, stop_tol, sig)

    def _solve(self, max_iter, stop_tol, sig) -> List[SDPResult]:
        with trace.span("batch.start"):
            cfg = self.config
            max_iter = cfg.max_iter if max_iter is None else int(max_iter)
            stop_tol = cfg.stop_tol if stop_tol is None else float(stop_tol)
            sig = cfg.sig if sig is None else float(sig)
            B = len(self.problems)
            step = make_step(
                stop_tol=stop_tol,
                switch_admm=cfg.switch_admm,
                sig_update_threshold=cfg.sig_update_threshold,
                sig_update_stage_1=cfg.sig_update_stage_1,
                sig_min=cfg.sig_min,
                sig_max=cfg.sig_max,
                eig_rank=cfg.eig_rank,
                projection=self._projection,
            )
            state = self._initial_states(sig)
            info_rows = []
            t0 = time.perf_counter()
            it_done = 0
            conv_iter = np.full(B, -1, dtype=np.int64)
        while it_done < max_iter:
            chunk = min(cfg.check_every, max_iter - it_done)
            with trace.span("batch.chunk"):
                state, info = self._runners.run(step, state, self.params, it_done, chunk, self.mesh)
            with trace.span("batch.check"):
                info_np = self._gather(info, 1).cpu().numpy().astype(np.float64)  # (chunk, B, 8)
                kkt = np.maximum(np.maximum(info_np[:, :, 2], info_np[:, :, 3]), info_np[:, :, 4])
                for b in range(B):
                    if conv_iter[b] < 0:
                        hits = np.nonzero(kkt[:, b] < stop_tol)[0]
                        if hits.size:
                            conv_iter[b] = it_done + int(hits[0]) + 1
                info_rows.append(info_np)
                it_done += chunk
            if np.all(conv_iter >= 0):
                break
        with trace.span("batch.finish"):
            return self._results(state, info_rows, conv_iter, it_done, time.perf_counter() - t0)

    def _results(self, state: SolverState, info_rows: list, conv_iter: np.ndarray, it_done: int,
                 total_time: float) -> List[SDPResult]:
        """Every instance's ``SDPResult`` from the final (local) state."""
        B = len(self.problems)
        info_mat = np.concatenate(info_rows, axis=0) if info_rows else np.empty((0, B, len(INFO_FIELDS)))
        # This rank's instances unscaled, one row each: X, y, S and the
        # scalars; then every instance's rows on every rank.
        maps = self.params.maps
        host = lambda t: t.cpu().numpy()
        names = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig")
        rows = []
        for b, sc in enumerate(self._scalings):
            X, y, S = scaling_mod.unscale_solution(
                sc, host(svec_from_pool(state.X[b], maps)), host(state.y[b]), host(svec_from_pool(state.S[b], maps)))
            rows.append(np.concatenate([X, y, S, [float(getattr(state, k)[b]) for k in names]]).astype(X.dtype))
        every = host(self._gather(torch.as_tensor(np.stack(rows), device=self.device), 0))
        vec_len, con_num = self._base.problem.vec_len, self._base.problem.con_num
        scalars = {k: every[:, 2 * vec_len + con_num + i].astype(np.float64) for i, k in enumerate(names)}
        results = []
        for b in range(B):
            converged = bool(conv_iter[b] >= 0)
            iters = int(conv_iter[b]) if converged else it_done
            X, y, S = np.split(every[b, :2 * vec_len + con_num], [vec_len, vec_len + con_num])
            info_b = info_mat[:iters, b, :]
            info = {name: info_b[:, i] for i, name in enumerate(INFO_FIELDS)}
            info["iter_num"] = np.asarray(iters)
            info["total_time"] = np.asarray(total_time)
            results.append(SDPResult(
                X=X,
                y=y,
                S=S,
                iterations=iters,
                converged=converged,
                diverged=not bool(np.isfinite(scalars["errRp"][b]) and np.isfinite(scalars["errRd"][b])),
                message="Solver ended: converged." if converged else "Solver ended: maximum iteration reached",
                pobj=float(scalars["pobj"][b]),
                dobj=float(scalars["dobj"][b]),
                errRp=float(scalars["errRp"][b]),
                errRd=float(scalars["errRd"][b]),
                relgap=float(scalars["relgap"][b]),
                sig=float(scalars["sig"][b]),
                total_time=total_time,
                info=info,
            ))
        return results
