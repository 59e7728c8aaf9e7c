"""Shared helpers for cone-programming format importers."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

SQRT2 = np.sqrt(2.0)


def svec_index(k: int, l: int) -> int:
    """Position of entry (k, l), k >= l, in a block's svec segment
    (tril row-major, the reference's traversal; src/utils/get_maps.cu:48-56)."""
    return k * (k + 1) // 2 + l


def block_offsets(blk: List[Tuple[str, int]]) -> np.ndarray:
    """svec offset of each block."""
    offs = np.zeros(len(blk) + 1, dtype=np.int64)
    for i, (t, n) in enumerate(blk):
        offs[i + 1] = offs[i] + (n * (n + 1) // 2 if t == "s" else n)
    return offs


def full_to_svec_triplets(n: int, rows, cols, vals):
    """Map COO entries of a (possibly unsymmetric) full n x n matrix to svec
    entries of its symmetric part (M + M^T)/2, with the sqrt(2) convention.

    Returns (svec_positions, svec_values) with duplicates *not* merged.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    k = np.maximum(rows, cols)
    l = np.minimum(rows, cols)
    pos = k * (k + 1) // 2 + l
    diag = rows == cols
    # Symmetrization halves off-diagonal contributions from each triangle;
    # the svec convention multiplies off-diagonal entries by sqrt(2).
    sv = np.where(diag, vals, vals * (SQRT2 / 2.0))
    return pos, sv


def tril_to_svec_triplets(n: int, rows, cols, vals):
    """Map lower-triangle COO entries (k >= l, each off-diagonal entry given
    once and standing for both (k,l) and (l,k)) to svec entries."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, dtype=np.float64)
    k = np.maximum(rows, cols)
    l = np.minimum(rows, cols)
    pos = k * (k + 1) // 2 + l
    sv = np.where(k == l, vals, vals * SQRT2)
    return pos, sv


def merge_coo(rows, cols, vals, shape):
    """Sum duplicate entries and return a csc matrix."""
    return sp.csc_matrix((vals, (rows, cols)), shape=shape)
