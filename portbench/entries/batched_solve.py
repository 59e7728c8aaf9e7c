"""``BatchedSDPSolver.solve`` from the cold start: a family of instances
sharing (blk, A), solved in lockstep on one device.

The problem is a family (``generators/toroidal_maxcut_family.py``:
``objectives`` and ``instance(i)``). ``solve(max_iter)`` runs ``max_iter``
batch iterations and reports ``iterations`` as instance-iterations (the
instances times the batch iterations), so that ``it_per_s`` is the family's
throughput on the scale of a single solve's. X, y and S are the instances'
vectors joined in instance order, ``info`` their info rows stacked instance
after instance, ``failure`` the first instance's failure (sdp_solve.py's
test on each).
"""

from __future__ import annotations

import numpy as np

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.parallel.batch import BatchedSDPSolver
from cuadmm_tpu_torch.problem import Problem
from portbench.entries.sdp_solve import INFO_FIELDS, failure
from portbench.problem import ProblemArrays


def to_problem(p: ProblemArrays) -> Problem:
    return Problem(blk=p.blk, con_num=p.con_num, At_rows=p.At_rows, At_cols=p.At_cols, At_vals=p.At_vals,
                   b_indices=p.b_indices, b_vals=p.b_vals, C_indices=p.C_indices, C_vals=p.C_vals, name=p.name)


class Program:
    def __init__(self, prob, settings: dict, device):
        self.vec_len = prob.vec_len
        problems = [to_problem(prob.instance(i)) for i in range(len(prob.objectives))]
        self.solver = BatchedSDPSolver(problems, SolverConfig(verbose=False, **settings), device=device)
        self.init_breakdown = getattr(self.solver, "init_breakdown", None)

    def solve(self, max_iter: int, stop_tol: float) -> dict:
        results = self.solver.solve(max_iter=max_iter, stop_tol=stop_tol)
        failures = [(i, failure(r, self.vec_len)) for i, r in enumerate(results)]
        bad = [f"instance {i}: {f}" for i, f in failures if f]
        return dict(X=np.concatenate([r.X for r in results]), y=np.concatenate([r.y for r in results]),
                    S=np.concatenate([r.S for r in results]),
                    info=np.concatenate([np.stack([r.info[f] for f in INFO_FIELDS], axis=1) for r in results]),
                    iterations=sum(r.iterations for r in results), failure=bad[0] if bad else None)

    def facts(self) -> dict:
        """The route ``auto`` took, the projection each bucket resolved to
        (None where the program does not say), the chunk runner and the
        instances."""
        neq = self.solver.params.neq
        inv_l = getattr(neq, "inv_l", None)
        return dict(normal_solver=neq.mode, applies=neq.applies, split_p=getattr(neq, "split_p", None),
                    n_pad=None if inv_l is None else int(inv_l.shape[0]),
                    projection=getattr(self.solver, "_projection", None), chunk_runner=self.solver.chunk_runner,
                    instances=len(self.solver.problems), switch_admm=self.solver.config.switch_admm)

    def captures(self) -> tuple:
        """(the chunk runner, the branches it has recorded), as sdp_solve.py's."""
        runner = self.solver._runners.runner
        return runner, (0 if runner is None else len(runner.recordings))


def build(prob, settings: dict, device) -> Program:
    return Program(prob, settings, device)
