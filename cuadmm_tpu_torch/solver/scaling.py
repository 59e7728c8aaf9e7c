"""Problem scaling / unscaling pipeline.

Mirrors the reference init-time scaling exactly
(reference: src/solver.cu:167-228) and the final unscaling
(src/solver.cu:813-816). All of this runs once on the host in float64
regardless of the solve dtype, to keep the scale factors exact.

Pipeline:
  1. normA[i] = max(1, ||row i of A||); A /= normA (row-wise)
  2. norm_borg = 1 + ||b||, norm_Corg = 1 + ||C||   (original b, C)
  3. b /= normA;  y0 *= normA  (warm start)
  4. bscale = 1 + ||b||, Cscale = 1 + ||C||, objscale = bscale*Cscale
  5. b /= bscale; C /= Cscale; X0 /= bscale; S0 /= Cscale; y0 /= Cscale
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Scaling:
    normA: np.ndarray
    bscale: float
    Cscale: float
    objscale: float
    norm_borg: float
    norm_Corg: float


def scale_problem(
    normA: np.ndarray,
    b_dense: np.ndarray,
    C_dense: np.ndarray,
    X0: Optional[np.ndarray],
    y0: Optional[np.ndarray],
    S0: Optional[np.ndarray],
):
    """Returns (Scaling, b_scaled, C_scaled, X0s, y0s, S0s).

    ``normA`` must already contain the clamped row norms (the constraint
    matrix itself is normalized separately, see ops.sparse.normalize_rows).
    """
    con_num = len(b_dense)
    vec_len = len(C_dense)

    norm_borg = 1.0 + float(np.linalg.norm(b_dense))
    norm_Corg = 1.0 + float(np.linalg.norm(C_dense))

    b = b_dense / normA
    y = np.zeros(con_num) if y0 is None else np.asarray(y0, dtype=np.float64) * normA

    bscale = 1.0 + float(np.linalg.norm(b))
    Cscale = 1.0 + float(np.linalg.norm(C_dense))
    objscale = bscale * Cscale

    b = b / bscale
    C = C_dense / Cscale
    X = np.zeros(vec_len) if X0 is None else np.asarray(X0, dtype=np.float64) / bscale
    S = np.zeros(vec_len) if S0 is None else np.asarray(S0, dtype=np.float64) / Cscale
    y = y / Cscale

    sc = Scaling(
        normA=normA,
        bscale=bscale,
        Cscale=Cscale,
        objscale=objscale,
        norm_borg=norm_borg,
        norm_Corg=norm_Corg,
    )
    return sc, b, C, X, y, S


def rescale_warm(sc: Scaling, X, y, S):
    """Scale externally-provided (unscaled) iterates for a re-entrant solve
    (reference: src/solver.cu:385-393)."""
    return (
        np.asarray(X, dtype=np.float64) / sc.bscale,
        np.asarray(y, dtype=np.float64) * sc.normA / sc.Cscale,
        np.asarray(S, dtype=np.float64) / sc.Cscale,
    )


def unscale_solution(sc: Scaling, X, y, S):
    """Recover original-units X, y, S (reference: src/solver.cu:813-816)."""
    X = np.asarray(X, dtype=np.float64) * sc.bscale
    y = np.asarray(y, dtype=np.float64) / sc.normA * sc.Cscale
    S = np.asarray(S, dtype=np.float64) * sc.Cscale
    return X, y, S
