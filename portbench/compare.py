"""The comparison that decides ``correct``: each solve of the window against
the reference's solve of the same problem from the same cold start.

Two numbers, each the worst over the window's solves:

- ``iterate_gap``: the largest of ||X - X_ref|| / ||X_ref||, the same of y
  and of S (2-norms of the unscaled iterates the solve returns);
- ``info_gap``: the largest gap, over every iteration's info row, of the
  residuals errRp and errRd (already relative to 1 + ||b|| and
  1 + ||C||) and of the objectives pobj and dobj relative to
  1 + |pobj_ref| + |dobj_ref|, the scale of the relative gap.

A solve that ran another number of iterations than the reference, or
whose numbers are not finite, reads UNCOMPARABLE (1e308, which JSON can
carry where it cannot carry infinity).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# Columns of the info rows (INFO_FIELDS).
POBJ, DOBJ, ERRRP, ERRRD = 0, 1, 2, 3
UNCOMPARABLE = 1e308


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def gaps(res: dict, ref: dict) -> Dict[str, float]:
    if res["iterations"] != ref["iterations"] or res["info"].shape != ref["info"].shape:
        return dict(iterate_gap=UNCOMPARABLE, info_gap=UNCOMPARABLE)
    iterate = float(np.max([_rel(res[k], ref[k]) for k in ("X", "y", "S")]))  # NaN stays NaN
    p, r = res["info"], ref["info"]
    scale = 1.0 + np.abs(r[:, POBJ]) + np.abs(r[:, DOBJ])
    info = np.concatenate([
        np.abs(p[:, ERRRP] - r[:, ERRRP]), np.abs(p[:, ERRRD] - r[:, ERRRD]),
        np.abs(p[:, POBJ] - r[:, POBJ]) / scale, np.abs(p[:, DOBJ] - r[:, DOBJ]) / scale,
    ])
    worst = float(np.max(info)) if info.size else 0.0
    return {k: v if math.isfinite(v) else UNCOMPARABLE for k, v in (("iterate_gap", iterate), ("info_gap", worst))}


def judge(results: List[dict], ref: dict, limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value": worst over ``results``, "limit": its limit}}."""
    worst = {k: 0.0 for k in limits}
    for res in results:
        for k, v in gaps(res, ref).items():
            if k in worst:
                worst[k] = max(worst[k], v)
    return {k: dict(value=worst[k], limit=float(limits[k])) for k in limits}
