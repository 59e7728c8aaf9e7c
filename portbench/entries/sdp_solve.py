"""``SDPSolver.solve`` from the cold start: one problem, one device."""

from __future__ import annotations

from typing import Optional

import numpy as np

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver.driver import SDPSolver
from portbench.problem import ProblemArrays

INFO_FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig", "bscale", "Cscale")


def failure(res, vec_len: int) -> Optional[str]:
    """chip_smoke.py's ``_gates`` as a failure test of one solve: None, or
    what went wrong (non-finite residuals or divergence, an errRp that did
    not fall, a bad X)."""
    err = res.info["errRp"]
    if not (np.isfinite(res.errRp) and np.isfinite(res.errRd) and np.isfinite(res.relgap)
            and not res.diverged and np.all(np.isfinite(err))):
        return "non-finite residuals or divergence"
    if not (len(err) >= 2 and err[-1] < err[0]):
        return f"errRp did not decrease ({err[0] if len(err) else None} -> {err[-1] if len(err) else None})"
    if res.X.shape != (vec_len,) or not np.all(np.isfinite(res.X)):
        return "bad X"
    return None


class Program:
    def __init__(self, prob: ProblemArrays, settings: dict, device):
        self.vec_len = prob.vec_len
        problem = Problem(blk=prob.blk, con_num=prob.con_num, At_rows=prob.At_rows, At_cols=prob.At_cols,
                          At_vals=prob.At_vals, b_indices=prob.b_indices, b_vals=prob.b_vals,
                          C_indices=prob.C_indices, C_vals=prob.C_vals, name=prob.name)
        self.solver = SDPSolver(problem, SolverConfig(verbose=False, **settings), device=device)
        self.init_breakdown = self.solver.init_breakdown

    def solve(self, max_iter: int, stop_tol: float) -> dict:
        res = self.solver.solve(max_iter=max_iter, stop_tol=stop_tol)
        return dict(X=res.X, y=res.y, S=res.S, info=np.stack([res.info[f] for f in INFO_FIELDS], axis=1),
                    iterations=res.iterations, failure=failure(res, self.vec_len))

    def facts(self) -> dict:
        """The route ``auto`` took and what the per-layer readers count by."""
        neq = self.solver.params.neq
        inv_l = getattr(neq, "inv_l", None)
        return dict(normal_solver=neq.mode, applies=neq.applies, split_p=getattr(neq, "split_p", None),
                    n_pad=None if inv_l is None else int(inv_l.shape[0]),
                    projection=self.solver._projection, chunk_runner=self.solver.chunk_runner,
                    switch_admm=self.solver.config.switch_admm)

    def captures(self) -> tuple:
        """(the chunk runner, the branches it has recorded): a solve that
        replays the graphs of an earlier one leaves both as they were."""
        runner = self.solver._runners.runner
        return runner, (0 if runner is None else len(runner.recordings))


def build(prob: ProblemArrays, settings: dict, device) -> Program:
    return Program(prob, settings, device)
