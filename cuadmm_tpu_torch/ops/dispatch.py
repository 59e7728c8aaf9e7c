"""Calibrated projection-method dispatch.

Port of cuadmm_tpu/ops/dispatch.py. A committed sweep
(``python -m cuadmm_tpu_torch.eig_sweep`` ->
``cuadmm_tpu_torch/data/eig_sweep_<backend>_<dtype>.jsonl``) times each
projection method per (block size, batch count) point; ``choose_methods``
picks the fastest method per bucket by nearest-neighbour lookup in log
space. The backend is "cuda" on the card; "cpu" reads the port's copy of
the JAX package's CPU table, so parity tests can pin either. For the same
table the port chooses what the JAX package chooses.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Tuple, Union

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

METHODS = ("eigh", "poly", "jacobi")


def bucket_method(method: Union[str, Dict[int, str]], i: int) -> str:
    """Bucket ``i``'s method under ``method``: one method for every bucket,
    or a per-bucket dict in which a bucket it does not name takes "eigh"."""
    return method.get(i, "eigh") if isinstance(method, dict) else method


def sweep_path(backend: str, dtype_name: str) -> str:
    return os.path.join(_DATA_DIR, f"eig_sweep_{backend}_{dtype_name}.jsonl")


def load_sweep(backend: str, dtype_name: str) -> Optional[List[dict]]:
    path = sweep_path(backend, dtype_name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return rows or None


def _nearest(rows: List[dict], n: int, batch: int) -> dict:
    """Nearest sweep point in (log n, log batch) space."""
    ln, lb = math.log(max(n, 1)), math.log(max(batch, 1))

    def d(r):
        return (math.log(r["n"]) - ln) ** 2 + (math.log(max(r["batch"], 1)) - lb) ** 2

    return min(rows, key=d)


def choose_methods(
    buckets: List[Tuple[int, int]], backend: str, dtype_name: str
) -> Optional[Dict[int, str]]:
    """Per-bucket method ("clamp" for 1x1, else "eigh" | "poly" | "jacobi")
    from the committed sweep. ``buckets`` is [(n, count), ...] in bucket
    order. Returns None when no table exists for ``backend``/``dtype_name``.
    """
    rows = load_sweep(backend, dtype_name)
    if rows is None:
        return None
    out: Dict[int, str] = {}
    for i, (n, count) in enumerate(buckets):
        if n == 1:
            out[i] = "clamp"
            continue
        r = _nearest(rows, n, count)
        timed = {m: r[f"{m}_ms"] for m in METHODS if f"{m}_ms" in r}
        out[i] = min(timed, key=timed.get) if timed else "eigh"
    return out
