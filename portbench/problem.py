"""The problem both sides of a comparison are given: plain numpy arrays.

Field names follow the program's ``Problem`` (svec coordinates: per block
the lower triangle row-major, off-diagonals scaled by sqrt(2); A^T as COO
triplets sorted constraint-major), so the harness can hand the same arrays
to the program and to the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class ProblemArrays:
    blk: List[Tuple[str, int]]
    con_num: int
    At_rows: np.ndarray
    At_cols: np.ndarray
    At_vals: np.ndarray
    b_indices: np.ndarray
    b_vals: np.ndarray
    C_indices: np.ndarray
    C_vals: np.ndarray
    name: str = ""

    @property
    def vec_len(self) -> int:
        return sum(n * (n + 1) // 2 if t == "s" else n for t, n in self.blk)

    def dense_b(self) -> np.ndarray:
        out = np.zeros(self.con_num)
        out[self.b_indices] = self.b_vals
        return out

    def dense_C(self) -> np.ndarray:
        out = np.zeros(self.vec_len)
        out[self.C_indices] = self.C_vals
        return out
