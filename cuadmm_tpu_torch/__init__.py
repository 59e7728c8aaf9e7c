"""cuadmm_tpu_torch: the sGS-ADMM SDP solver on PyTorch and CUDA.

The port of ``cuadmm_tpu`` (JAX) to PyTorch for NVIDIA Hopper. It imports
torch and never jax; ``cuadmm_tpu`` stays the reference its tests compare
against. Ported so far: float64 and float32 state (``dtype="float32"``
with the f64 tables of the refinement, the true-residual probe, the
precision-stall detector and the f64 primal residuals ``rp_hp``) with
every normal solver: ``precond`` and ``split`` (whose
inverse factor, or coupled prefix's, runs the hand-written CUDA kernel K1,
ops/precond_apply.py), ``packed`` and ``banded`` (K2/K3,
ops/tri_stream.py), ``dense``, ``cg``, ``host`` and ``sharded`` (over a
rank mesh, parallel/tri_shard.py), with ``auto`` resolving among them
(on CUDA by the card's own limits, ops/limits.py); divergence recovery at both levels; the PSD
projection with its "eigh", "poly", "jacobi" and calibrated "auto"
methods ("jacobi" runs the hand-written CUDA kernel K4, ops/jacobi.py),
in pool and in svec coordinates (``psd_project``);
``solve_escalated``; the batched multi-instance solver; and several
devices: a rank mesh over torch.distributed (parallel/mesh.py, one
process per rank; ``parallel.launch.run_ranks`` starts ranks on one host,
torchrun on several), ``SDPSolver(mesh=)``, ``solve_escalated(mesh=)``
and ``BatchedSDPSolver(mesh=)``.

Front ends, as in the JAX package (each runs on ``device="cuda"`` unless
the CPU is asked for):
    python -m cuadmm_tpu_torch solve DIR / info DIR  -- the CLI (cli.py)
    compat.cuadmm             -- the MATLAB-style MEX signature
    io.sdpa.load_sdpa         -- SDPA .dat-s (and .dat-s.gz)
    io.sedumi.load_sedumi_mat -- SeDuMi .mat (A or At, b, c, K)
    io.mosek.load_mosek_mat   -- MOSEK .mat ('prob' struct)
    io.admm_mat.load_admm_mat -- cuADMM .mat (At, b, C in svec layout)
    utils.checkpoint          -- .npz checkpoints, the JAX package's format
    examples.minimizer, examples.maxcut_demo, examples.mosek_pipeline

Public API:
    Problem          -- problem container + TXT loader
    SDPSolver        -- init/solve driver on an explicit ``device``
    SolverConfig     -- the JAX package's configuration, unchanged
    solve            -- one-shot convenience wrapper
    solve_escalated  -- f32 solve with an f64 tail past the f32 floor
    BatchedSDPSolver -- lockstep solve of instances sharing (blk, A)
    parallel.mesh.make_mesh -- this rank's Mesh (SDPSolver(mesh=...))
"""

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.parallel.batch import BatchedSDPSolver
from cuadmm_tpu_torch.solver.driver import SDPResult, SDPSolver, solve, solve_escalated
from cuadmm_tpu_torch.structure import BlockStructure

__all__ = [
    "Problem",
    "SDPSolver",
    "SDPResult",
    "SolverConfig",
    "BlockStructure",
    "BatchedSDPSolver",
    "solve",
    "solve_escalated",
]
