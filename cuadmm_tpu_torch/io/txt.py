"""TXT problem-format readers and writers.

File format (reference: README.md "Input format", src/utils/io.cu):

- dense vector files: one value per line.
- sparse vector files: lines of ``index 0 value`` (column always 0).
- sparse matrix files (COO): lines of ``row col value``, 0-based.
- ``blk.txt``: one block per line, either ``<type> <size>`` (e.g. ``s 10``)
  or bare ``<size>`` meaning ``s <size>`` (reference: src/utils/io.cu:296-329).

Parsing is NumPy only: the native tokenizer of ``cuadmm_tpu._native``
lives in the JAX package, whose import pulls in jax.
"""

from __future__ import annotations

import os
import re
from typing import List, Tuple

import numpy as np


def _parse_numbers(filename: str) -> np.ndarray:
    """Whitespace-tokenized float parse of an entire file."""
    with open(filename, "rb") as f:
        data = f.read()
    if not data.strip():
        return np.empty((0,), dtype=np.float64)
    return np.array(data.split(), dtype=np.float64)


def read_dense_vector(filename: str) -> np.ndarray:
    """Read a dense vector: one value per line (reference: io.cu:20-41)."""
    return _parse_numbers(filename)


def read_sparse_vector(filename: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a sparse vector: ``index 0 value`` lines (reference: io.cu:66-93).

    Returns (indices int32, values float64).
    """
    nums = _parse_numbers(filename)
    if nums.size % 3 != 0:
        raise ValueError(f"{filename}: sparse vector file length not divisible by 3")
    trip = nums.reshape(-1, 3)
    if np.any(trip[:, 1] != 0):
        import warnings

        warnings.warn(f"{filename}: sparse vector data has a non-zero column index")
    return trip[:, 0].astype(np.int32), np.ascontiguousarray(trip[:, 2])


def read_coo_matrix(filename: str, transpose: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a COO sparse matrix: ``row col value`` lines (reference: io.cu:96-132).

    Returns (rows int32, cols int32, vals float64); with ``transpose`` the
    row/col roles are swapped.
    """
    nums = _parse_numbers(filename)
    if nums.size % 3 != 0:
        raise ValueError(f"{filename}: COO file length not divisible by 3")
    trip = nums.reshape(-1, 3)
    rows = trip[:, 0].astype(np.int32)
    cols = trip[:, 1].astype(np.int32)
    vals = np.ascontiguousarray(trip[:, 2])
    if transpose:
        rows, cols = cols, rows
    return rows, cols, vals


_BLK_TYPE_VAL = re.compile(r"^\s*([a-zA-Z])\s+(-?\d+)\s*$")
_BLK_VAL_ONLY = re.compile(r"^\s*(-?\d+)\s*$")


def read_blk(filename: str) -> List[Tuple[str, int]]:
    """Read the block-structure file (reference: io.cu:296-329).

    Lines are ``<letter> <int>`` or bare ``<int>`` (implying type ``s``);
    malformed lines are ignored, matching the reference.
    """
    out: List[Tuple[str, int]] = []
    with open(filename, "r") as f:
        for line in f:
            m = _BLK_TYPE_VAL.match(line)
            if m:
                out.append((m.group(1), int(m.group(2))))
                continue
            m = _BLK_VAL_ONLY.match(line)
            if m:
                out.append(("s", int(m.group(1))))
    return out


def write_dense_vector(filename: str, vals: np.ndarray, precision: int = 16) -> None:
    """One value per line (reference: io.cu:137-154)."""
    np.savetxt(filename, np.asarray(vals), fmt=f"%.{precision}g")


def write_sparse_vector(filename: str, indices: np.ndarray, vals: np.ndarray, precision: int = 16) -> None:
    with open(filename, "w") as f:
        for i, v in zip(np.asarray(indices), np.asarray(vals)):
            f.write(f"{int(i)} 0 {v:.{precision}g}\n")


def write_coo_matrix(
    filename: str, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, precision: int = 16
) -> None:
    """``row col value`` lines (reference: io.cu:178-196)."""
    with open(filename, "w") as f:
        for r, c, v in zip(np.asarray(rows), np.asarray(cols), np.asarray(vals)):
            f.write(f"{int(r)} {int(c)} {v:.{precision}g}\n")


def write_blk(filename: str, blk: List[Tuple[str, int]]) -> None:
    with open(filename, "w") as f:
        for t, n in blk:
            f.write(f"{t} {n}\n")


def coo_sort(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, order: str = "col-major"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort COO triplets lexicographically.

    ``col-major`` sorts by (col, row) -- the order the reference's
    COO_to_CSC produces (reference: io.cu:203-257); ``row-major`` by
    (row, col).
    """
    if order == "col-major":
        perm = np.lexsort((rows, cols))
    elif order == "row-major":
        perm = np.lexsort((cols, rows))
    else:
        raise ValueError(order)
    return rows[perm], cols[perm], vals[perm]


def coo_to_csc_ptrs(cols_sorted: np.ndarray, col_num: int) -> np.ndarray:
    """Column pointers for (col,row)-sorted triplets (reference: io.cu:203-257)."""
    counts = np.bincount(cols_sorted, minlength=col_num)
    ptrs = np.zeros(col_num + 1, dtype=np.int64)
    np.cumsum(counts, out=ptrs[1:])
    return ptrs
