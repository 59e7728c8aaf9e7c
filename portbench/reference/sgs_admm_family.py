"""Plain sGS-ADMM in float64 over a family of instances sharing (blk, A, b):
sgs_admm.py's algorithm, one instance after another.

AA^T is factored once, by ``sgs_admm.Reference`` on instance 0; each
other instance takes that reference with its own C and C's scalings, and
every instance is solved from its own cold start. The result has the
layout of ``entries/batched_solve.py``: X, y and S joined in instance
order, the info rows stacked instance after instance, the iterations
added up.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from portbench.reference import sgs_admm


def with_objective(ref: sgs_admm.Reference, C: np.ndarray) -> sgs_admm.Reference:
    """``ref`` (A, b and its factor shared) with the objective ``C``, scaled
    as ``sgs_admm.Reference`` scales its own."""
    out = copy.copy(ref)
    out.norm_Corg = 1.0 + float(np.linalg.norm(C))
    out.Cscale = 1.0 + float(np.linalg.norm(C))
    out.objscale = out.bscale * out.Cscale
    out.C = torch.as_tensor(C / out.Cscale, dtype=sgs_admm.F64, device=ref.device)
    return out


class Reference:
    """Solves of every instance of the family ``prob`` (``objectives`` and
    ``instance(i)``) under a configuration's ``solver`` settings, in
    float64 on ``device``."""

    def __init__(self, prob, settings: dict, device):
        instances = [prob.instance(i) for i in range(len(prob.objectives))]
        b = instances[0].dense_b()
        if any(not np.array_equal(p.dense_b(), b) for p in instances[1:]):
            raise ValueError("the family's instances must share b")
        base = sgs_admm.Reference(instances[0], settings, device)
        self.refs = [base] + [with_objective(base, p.dense_C()) for p in instances[1:]]

    def solve(self, max_iter: int, stop_tol: float) -> dict:
        """Each instance's solve from the cold start, joined."""
        out = [ref.solve(max_iter, stop_tol) for ref in self.refs]
        return dict(X=np.concatenate([o["X"] for o in out]), y=np.concatenate([o["y"] for o in out]),
                    S=np.concatenate([o["S"] for o in out]), info=np.concatenate([o["info"] for o in out]),
                    iterations=sum(o["iterations"] for o in out), diverged=any(o["diverged"] for o in out))
