"""Jobs that ``parallel.launch.run_ranks`` runs on every rank of a mesh.

A spawned rank imports the job's module, so the jobs live here, in the
port: they import neither jax nor a test module. Each takes the rank's
``Mesh`` first and returns numpy arrays and plain values, which the
parent compares with the JAX package or with a one-rank run.

``run_checks(mesh, checks)`` runs several named checks in one spawn, so
the ranks' start is paid once: ``checks`` is a list of (name, job,
keyword arguments), each job a module-level function such as those here
(a spawned rank unpickles it by reference), and the result maps each
name to its check's result.
``chip_mesh`` is chip_smoke.py's mesh phase on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.device import synchronize
from cuadmm_tpu_torch.ops.chol import ShardedFactor
from cuadmm_tpu_torch.ops.sparse import aat_matvec
from cuadmm_tpu_torch.ops.projection import psd_project, psd_project_pool
from cuadmm_tpu_torch.ops.svec import device_maps, pool_from_svec, svec_from_pool
from cuadmm_tpu_torch.parallel import tri_shard
from cuadmm_tpu_torch.parallel.batch import BatchedSDPSolver
from cuadmm_tpu_torch.parallel.mesh import Mesh, shard_axis, shard_bounds
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver.driver import SDPResult, SDPSolver, solve_escalated
from cuadmm_tpu_torch.structure import BlockStructure

RESULT_SCALARS = ("iterations", "converged", "diverged", "pobj", "dobj", "errRp", "errRd", "relgap", "sig")


def result_dict(res: SDPResult) -> Dict[str, Any]:
    """An SDPResult as plain values and arrays: its scalars, X, y, S and
    the info rows."""
    return dict({k: getattr(res, k) for k in RESULT_SCALARS}, X=res.X, y=res.y, S=res.S, info=dict(res.info))


def run_checks(mesh: Mesh, checks: Sequence[Tuple[str, Callable[..., Any], dict]]) -> Dict[str, Any]:
    """Each (name, job, kwargs) of ``checks`` in order: {name: job(mesh, **kwargs)}."""
    return {name: job(mesh, **kw) for name, job, kw in checks}


def project(mesh: Mesh, blk, svec: np.ndarray, method: str = "eigh", pack_to: int = 0) -> Dict[str, Any]:
    """The projection of one svec vector over the mesh through the pool
    (``psd_project_pool``) and in svec coordinates (``psd_project``): both
    projected svecs, the all_reduces each took, and each PSD bucket's
    (count, n, split axis, this rank's share)."""
    st = BlockStructure(blk, "pow2", 64, pack_to)
    maps = device_maps(st, torch.float64, mesh.device)
    x = torch.as_tensor(svec, device=mesh.device)
    before = trace.COUNTS["all_reduce"]
    out = svec_from_pool(psd_project_pool(pool_from_svec(x, maps), maps, method=method, mesh=mesh), maps)
    pooled = trace.COUNTS["all_reduce"] - before
    direct = psd_project(x, maps, method=method, mesh=mesh)
    shares = [(bk.count, bk.n, shard_axis((bk.count, bk.n, bk.n), mesh, method == "poly"),
               shard_bounds(bk.count, mesh)) for bk in st.buckets if bk.n > 1]
    return dict(svec=out.cpu().numpy(), all_reduces=pooled, svec_direct=direct.cpu().numpy(),
                direct_all_reduces=trace.COUNTS["all_reduce"] - before - pooled, shares=shares)


def solve(mesh: Mesh, prob: Problem, config: dict, runs: Sequence[Tuple[int, float]],
          grid: Optional[np.ndarray] = None, applies: Optional[int] = None) -> Dict[str, Any]:
    """SDPSolver(prob, SolverConfig(**config), mesh=mesh), then one solve per
    (max_iter, stop_tol) of ``runs``, each from the initial point. With
    ``grid`` (a global (nb, nb, B, B) factor grid, e.g. the JAX package's)
    the ``sharded`` solver's factor is replaced by this rank's slab of it,
    and its sweep count by ``applies``."""
    solver = SDPSolver(prob, SolverConfig(**config), mesh=mesh)
    neq = solver.params.neq
    if grid is not None:
        neq = dataclasses.replace(neq, factor=ShardedFactor(tri_shard.shard_factor(grid, mesh), mesh),
                                  applies=int(applies))
        solver.params = dataclasses.replace(solver.params, neq=neq)
    out = []
    for max_iter, stop_tol in runs:
        before = trace.COUNTS["all_reduce"]
        t0 = time.perf_counter()
        res = solver.solve(max_iter=max_iter, stop_tol=stop_tol)
        out.append(dict(result_dict(res), seconds=time.perf_counter() - t0,
                        all_reduces=trace.COUNTS["all_reduce"] - before))
    return dict(runs=out, mode=neq.mode, applies=neq.applies, eps_used=neq.eps_used,
                projection=solver._projection,
                grid_shape=tuple(neq.factor.grid.shape) if neq.mode == "sharded" else None)


def escalated(mesh: Mesh, prob: Problem, config: dict, max_iter: int, stop_tol: float) -> Dict[str, Any]:
    """``solve_escalated`` over the mesh."""
    return result_dict(solve_escalated(prob, SolverConfig(**config), max_iter, stop_tol, mesh=mesh))


def tri_solve(mesh: Mesh, square_tiles: np.ndarray, r: np.ndarray) -> np.ndarray:
    """``sharded_tri_solve`` of this rank's slab of a global factor grid."""
    slab = tri_shard.shard_factor(square_tiles, mesh)
    return tri_shard.sharded_tri_solve(slab, torch.as_tensor(r, device=mesh.device), mesh).cpu().numpy()


def cholesky(mesh: Mesh, aat, n: int, block: int, eps: float, diag_mean: float, r: np.ndarray,
             dtype: str = "float64") -> Dict[str, Any]:
    """This rank's slab of the distributed factor of AA^T + eps I, and the
    solve of ``r`` through it."""
    nb, _ = tri_shard.make_grid_layout(n, mesh.size, block)
    slab = tri_shard.sharded_scatter_aat(aat, n, nb, block, mesh, eps=eps, diag_mean=diag_mean,
                                         dtype=getattr(torch, dtype))
    slab = tri_shard.sharded_cholesky(slab, mesh)
    y = tri_shard.sharded_tri_solve(slab, torch.as_tensor(r, device=mesh.device), mesh)
    return dict(slab=slab.cpu().numpy(), y=y.cpu().numpy(), finite=tri_shard.last_diag_finite(slab, mesh))


def batch(mesh: Mesh, problems: List[Problem], config: dict, max_iter: int, stop_tol: float) -> List[dict]:
    """``BatchedSDPSolver(problems, mesh=mesh).solve``: every instance's result."""
    b = BatchedSDPSolver(problems, SolverConfig(**config), mesh=mesh)
    return [result_dict(r) for r in b.solve(max_iter=max_iter, stop_tol=stop_tol)]


def fail(mesh: Mesh, bad_rank: int) -> None:
    """Rank ``bad_rank`` raises; every other rank waits in a collective
    that the failed rank never joins."""
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    mesh.all_reduce(torch.ones(4, device=mesh.device))


def sleep(mesh: Mesh, seconds: float) -> None:
    """Every rank sleeps past the launcher's timeout."""
    time.sleep(seconds)


def grid_buckets_k4(mesh: Mesh, prob: Problem, svec: np.ndarray) -> Dict[str, Any]:
    """The jacobi projection of ``prob``'s buckets over the mesh: the
    projected svec and the K4 launches it took on this rank."""
    st = BlockStructure(prob.blk, "pow2", 64, 0)
    maps = device_maps(st, torch.float64, mesh.device)
    P = pool_from_svec(torch.as_tensor(svec, device=mesh.device), maps)
    trace.reset()
    out = svec_from_pool(psd_project_pool(P, maps, method="jacobi", mesh=mesh), maps)
    synchronize(mesh.device)
    return dict(svec=out.cpu().numpy(), k4=trace.COUNTS["k4"])


def _reset_counts() -> None:
    trace.reset()


def _counts() -> Dict[str, int]:
    return {k: trace.COUNTS[k] for k in ("k1", "k4", "k4_f32", "sym_mirror", "poly_tri_products", "all_reduce",
                                         "broadcast")}


def continued_run(solver, warm: int, iters: int) -> Tuple[SDPResult, float, Dict[str, int]]:
    """``warm`` iterations, then ``iters`` more from where they ended (a
    warm start from that result), timed, with every kernel's launch count
    and the collective counts set to 0 just before and read just after.
    Returns (result of the ``iters``, seconds, counts)."""
    w = solver.solve(max_iter=warm, stop_tol=0.0)
    synchronize(solver.device)
    _reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(max_iter=iters, stop_tol=0.0, X0=w.X, y0=w.y, S0=w.S, sig=w.sig)
    synchronize(solver.device)
    return res, time.perf_counter() - t0, _counts()


def _peak_gb(device) -> Optional[float]:
    return torch.cuda.max_memory_allocated(device) / 1e9 if device.type == "cuda" else None


def _free(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def sharded_large(mesh: Mesh, large: Problem, warm: int, timed: int) -> Dict[str, Any]:
    """``large`` (chip_smoke.py's 20x120 grid) with normal_solver
    "sharded", plain ADMM: its build (the distributed Cholesky inside),
    one normal solve of a consistent probe rhs timed and counted, ``warm``
    untimed iterations, then a timed solve of ``timed`` iterations from the
    start. Returns that run's result, seconds and counts, the build's
    seconds, the slab and this rank's peak memory."""
    dev = mesh.device
    admm = dict(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0)
    t0 = time.perf_counter()
    solver = SDPSolver(large, SolverConfig(projection="auto", normal_solver="sharded", **admm), mesh=mesh)
    init_s = time.perf_counter() - t0
    peak_init = _peak_gb(dev)
    neq = solver.params.neq
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(large.con_num), device=dev)
    rhs = aat_matvec(neq.sparse_a, v)
    synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    y = neq.solve(rhs)
    synchronize(dev)
    solve_ms, solve_counts = (time.perf_counter() - t0) * 1e3, _counts()
    resid = float(neq.residual_norm(rhs, y))
    solver.solve(max_iter=warm, stop_tol=0.0)
    synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(max_iter=timed, stop_tol=0.0)
    synchronize(dev)
    return dict(result_dict(res), seconds=time.perf_counter() - t0, counts=_counts(), init_s=init_s,
                init_breakdown=solver.init_breakdown, mode=neq.mode, applies=neq.applies,
                eps_used=neq.eps_used, slab_shape=tuple(neq.factor.grid.shape),
                slab_gb=neq.factor.grid.numel() * neq.factor.grid.element_size() / 1e9,
                solve_ms=solve_ms, solve_counts=solve_counts, residual_norm=resid,
                methods=solver._projection, peak_mem_gb_init=peak_init, peak_mem_gb=_peak_gb(dev))


def chip_mesh(mesh: Mesh, grid: Problem, large: Problem, quasar: Problem, family: List[Problem],
              iters: Dict[str, Tuple[int, int]]) -> Dict[str, Any]:
    """chip_smoke.py's runs over a rank mesh, in order, one solver at a time
    (``iters[name]`` = (warm, timed) iterations):

    - grid: the 20x60 grid, projection "jacobi", plain ADMM, precond + K1;
      ``continued_run``;
    - large: the 20x120 grid with normal_solver "sharded" (``sharded_large``);
    - quasar: QUASAR-500, projection "poly" (its one block split by rows),
      split + K1; ``warm`` untimed iterations, then ``timed`` from the
      start, timed;
    - batched: ``BatchedSDPSolver`` on ``family`` (precond + K1, the
      "auto" projection at this rank's share of the instances),
      ``warm`` then ``timed`` iterations, each from the start.

    Each entry has the result (or results), the seconds, the kernel and
    collective counts of the timed run, and this rank's peak memory."""
    dev = mesh.device
    admm = dict(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0)
    out: Dict[str, Any] = {}

    _free(dev)
    solver = SDPSolver(grid, SolverConfig(projection="jacobi", **admm), mesh=mesh)
    res, secs, counts = continued_run(solver, *iters["grid"])
    st = solver.structure
    out["grid"] = dict(result_dict(res), seconds=secs, counts=counts, applies=solver.params.neq.applies,
                       mode=solver.params.neq.mode,
                       n_pad=None if solver.params.neq.inv_l is None else int(solver.params.neq.inv_l.shape[0]),
                       local_buckets=[(bk.n, shard_bounds(bk.count, mesh)) for bk in st.buckets],
                       peak_mem_gb=_peak_gb(dev))
    del solver
    _free(dev)

    out["large"] = sharded_large(mesh, large, *iters["large"])
    _free(dev)

    solver = SDPSolver(quasar, SolverConfig(projection="poly", **admm), mesh=mesh)
    warm, timed = iters["quasar"]
    solver.solve(max_iter=warm, stop_tol=0.0)
    synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    res = solver.solve(max_iter=timed, stop_tol=0.0)
    synchronize(dev)
    neq = solver.params.neq
    out["quasar"] = dict(result_dict(res), seconds=time.perf_counter() - t0, counts=_counts(), mode=neq.mode,
                         split_p=neq.split_p, applies=neq.applies, peak_mem_gb=_peak_gb(dev))
    del solver, neq
    _free(dev)

    batch = BatchedSDPSolver(family, SolverConfig(**admm), mesh=mesh)
    warm, timed = iters["batched"]
    batch.solve(max_iter=warm, stop_tol=0.0)
    synchronize(dev)
    _reset_counts()
    t0 = time.perf_counter()
    results = batch.solve(max_iter=timed, stop_tol=0.0)
    synchronize(dev)
    out["batched"] = dict(results=[result_dict(r) for r in results], seconds=time.perf_counter() - t0,
                          counts=_counts(), local=(batch._lo, batch._hi), applies=batch.params.neq.applies,
                          mode=batch.params.neq.mode, peak_mem_gb=_peak_gb(dev))
    return out
