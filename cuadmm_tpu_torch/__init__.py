"""cuadmm_tpu_torch: the sGS-ADMM SDP solver on PyTorch and CUDA.

The port of ``cuadmm_tpu`` (JAX) to PyTorch for NVIDIA Hopper. It imports
torch and never jax; ``cuadmm_tpu`` stays the reference its tests compare
against. Ported so far: float64 state with the ``precond``, ``packed`` and
``banded`` normal solvers, whose factor applications run the hand-written
CUDA kernels K1 (ops/precond_apply.py) and K2/K3 (ops/tri_stream.py), and
the PSD projection with its "eigh", "poly",
"jacobi" and calibrated "auto" methods; "jacobi" runs the hand-written
CUDA kernel K4 (ops/jacobi.py).

Public API:
    Problem        -- problem container + TXT loader
    SDPSolver      -- init/solve driver on an explicit ``device``
    SolverConfig   -- the JAX package's configuration, unchanged
    solve          -- one-shot convenience wrapper
"""

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver.driver import SDPResult, SDPSolver, solve
from cuadmm_tpu_torch.structure import BlockStructure

__all__ = [
    "Problem",
    "SDPSolver",
    "SDPResult",
    "SolverConfig",
    "BlockStructure",
    "solve",
]
