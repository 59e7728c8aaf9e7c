"""A quick run of the several-devices path: the port's counterpart of
``__graft_entry__.py::dryrun_multichip`` (:65-140).

    dryrun_multichip(n_ranks, backend, device)

runs, over a mesh of ``n_ranks`` ranks, one solver step with the block
buckets split over the ranks, the sharded triangular solve of a packed
factor, and a ``sharded`` solve of a certified SDP to 1e-5 in f32, with
the JAX function's sizes and checks. Inside a process group of that size
(torchrun, or a caller that set one up) it runs in the calling process;
otherwise it starts the ranks with ``parallel.launch.run_ranks``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.ops import tri_stream
from cuadmm_tpu_torch.parallel import tri_shard
from cuadmm_tpu_torch.parallel.launch import run_ranks
from cuadmm_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S, Mesh, make_mesh
from cuadmm_tpu_torch.solver.driver import SDPSolver
from cuadmm_tpu_torch.solver.step import make_step


def dryrun_job(mesh: Mesh) -> dict:
    """The dry run on this rank of ``mesh``; raises on a failed check."""
    D = mesh.size
    # One step, every bucket split over the ranks (__graft_entry__.py:34-57).
    n_blocks = max(16, 2 * D)
    prob, *_ = random_certified_sdp([("s", 4)] * n_blocks + [("s", 6)] * n_blocks, con_num=24, seed=0)
    cfg = SolverConfig(dtype="float32", verbose=False, switch_admm=10**9)
    solver = SDPSolver(prob, cfg, mesh=mesh)
    step = make_step(stop_tol=cfg.stop_tol, switch_admm=cfg.switch_admm,
                     sig_update_threshold=cfg.sig_update_threshold, sig_update_stage_1=cfg.sig_update_stage_1,
                     sig_min=cfg.sig_min, sig_max=cfg.sig_max, projection=solver._projection, mesh=mesh)
    state = solver._initial_state(*solver._initial_scaled, cfg.sig)
    state, _ = step(state, solver.params, 0)
    if not (bool(torch.isfinite(state.errRp)) and int(state.it) == 1):
        raise RuntimeError(f"dry-run step: errRp {float(state.errRp)}, it {int(state.it)}")

    # The sharded triangular solve of a packed factor (:89-117).
    n, B = 16 * D, 16
    lay = tri_stream.make_layout(n, B)
    A = sp.random(n, 2 * n, density=0.1, random_state=1, format="csr")
    aat = (A @ A.T).tocoo()
    tiles = tri_stream.scatter_packed_aat(
        aat.row.astype(np.int64), aat.col.astype(np.int64), aat.data, lay, 1e-6,
        float(aat.diagonal().mean()), torch.float32, mesh.device,
    )
    if int(tri_stream.packed_cholesky(tiles, lay)) != 0:  # in place; nonzero: a tile did not factor
        raise RuntimeError("dry-run packed_cholesky failed")
    fac = tiles.cpu().numpy()
    slab = tri_shard.shard_factor(tri_shard.square_tiles_from_packed(fac, lay), mesh)
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(n).astype(np.float32), device=mesh.device)
    before = trace.COUNTS["all_reduce"]
    y = tri_shard.sharded_tri_solve(slab, r, mesh)
    solve_all_reduces = trace.COUNTS["all_reduce"] - before
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("dry-run sharded_tri_solve: non-finite result")

    # Factor and solve over the mesh inside the solver (:119-140).
    prob, _, _, _, opt = random_certified_sdp([("s", 6)] * (2 * D), con_num=40 * D, seed=1)
    cfg = SolverConfig(verbose=False, check_every=50, normal_solver="sharded", stop_tol=1e-5, dtype="float32")
    solver = SDPSolver(prob, cfg, mesh=mesh)
    if solver.params.neq.mode != "sharded":
        raise RuntimeError(f"dry-run: normal solver resolved to {solver.params.neq.mode!r}")
    res = solver.solve(max_iter=5000)
    gap = abs(res.pobj - opt) / (1 + abs(opt))
    if not (res.converged and gap < 1e-2):
        raise RuntimeError(f"dry-run sharded solve: converged {res.converged}, pobj {res.pobj} against {opt}")
    return dict(step_errRp=float(state.errRp), tri_solve=y.cpu().numpy(), tri_solve_all_reduces=solve_all_reduces,
                iterations=res.iterations, pobj=res.pobj, optimum=opt, X=res.X)


def dryrun_multichip(n_ranks: int, backend=None, device="cuda") -> list:
    """The dry run over ``n_ranks`` ranks; each rank's ``dryrun_job``
    result, in rank order. ``backend`` None: nccl on CUDA, gloo on the CPU
    (or, in a process group already started, the group's)."""
    if dist.is_initialized():
        return [dryrun_job(make_mesh(n_ranks, backend, device))]
    return run_ranks(dryrun_job, n_ranks, backend, device, timeout_s=DEFAULT_TIMEOUT_S)
