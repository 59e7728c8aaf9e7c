"""Random SDP generators with known optimal solutions.

The reference tests numerical ground truth against external solvers
(MOSEK/SDPNAL+/SCS via MATLAB drivers, reference: examples/run_admmplus.m,
examples/solve_with_scs.m). Without those, we construct problems whose
optimum is known by construction: pick complementary primal/dual optimal
pairs and back out (A, b, C) from the KKT conditions.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.structure import SQRT2


def _svec(m: np.ndarray) -> np.ndarray:
    n = m.shape[0]
    r, c = np.tril_indices(n)
    return m[r, c] * np.where(r == c, 1.0, SQRT2)


def random_certified_sdp(
    blk: Sequence[Tuple[str, int]],
    con_num: int,
    rank_frac: float = 0.5,
    density: float = 0.5,
    seed: int = 0,
):
    """Build (Problem, X*, y*, S*, pobj*) with certified optimum.

    Construction: per PSD block choose an orthonormal basis Q and a split
    of its columns; X* = Q1 diag(a) Q1^T (a>0), S* = Q2 diag(g) Q2^T (g>0)
    so X* S* = 0 and both are PSD. Free blocks get S* = 0. Draw random
    sparse A and y*, then set b = A x*, C = svec(S*) + A^T y*. Strong
    duality holds with zero gap: <C,X*> = <b,y*>.
    """
    rng = np.random.default_rng(seed)
    x_parts: List[np.ndarray] = []
    s_parts: List[np.ndarray] = []
    for t, n in blk:
        if t == "u":
            x_parts.append(rng.standard_normal(n))
            s_parts.append(np.zeros(n))
            continue
        q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        k = max(1, min(n - 1, int(round(rank_frac * n)))) if n > 1 else 1
        a = rng.uniform(0.5, 2.0, size=k)
        g = rng.uniform(0.5, 2.0, size=n - k) if n > k else np.zeros(0)
        X = (q[:, :k] * a) @ q[:, :k].T
        S = (q[:, k:] * g) @ q[:, k:].T if n > k else np.zeros((n, n))
        x_parts.append(_svec(X))
        s_parts.append(_svec(S))
    x_star = np.concatenate(x_parts)
    s_star = np.concatenate(s_parts)
    vec_len = len(x_star)

    A = rng.standard_normal((con_num, vec_len))
    A[rng.random((con_num, vec_len)) >= density] = 0.0
    # Guard against empty rows (singular AA^T beyond repair).
    for i in range(con_num):
        if not A[i].any():
            A[i, rng.integers(vec_len)] = 1.0
    y_star = rng.standard_normal(con_num)

    b = A @ x_star
    C = s_star + A.T @ y_star
    prob = Problem.from_dense(list(blk), A, b, C, name="random_certified")
    pobj = float(C @ x_star)
    return prob, x_star, y_star, s_star, pobj


def random_sdp(
    blk: Sequence[Tuple[str, int]], con_num: int, density: float = 0.5, seed: int = 0
) -> Problem:
    """Uncertified random feasible SDP (b from a strictly feasible X)."""
    rng = np.random.default_rng(seed)
    parts = []
    for t, n in blk:
        if t == "u":
            parts.append(rng.standard_normal(n))
            continue
        m = rng.standard_normal((n, n))
        parts.append(_svec(m @ m.T / n + np.eye(n)))
    x_feas = np.concatenate(parts)
    vec_len = len(x_feas)
    A = rng.standard_normal((con_num, vec_len))
    A[rng.random((con_num, vec_len)) >= density] = 0.0
    b = A @ x_feas
    C = rng.standard_normal(vec_len)
    return Problem.from_dense(list(blk), A, b, C, name="random_sdp")
