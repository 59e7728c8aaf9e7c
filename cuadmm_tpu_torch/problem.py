"""Problem container and TXT-directory loader.

Mirrors the reference's ``Problem::from_txt`` semantics
(reference: src/problem.cu:11-83, include/cuadmm/problem.h:16-41):
a problem directory holds At.txt / b.txt / C.txt / blk.txt / con_num.txt
plus optional X.txt / y.txt / S.txt warm starts.

The decision variable X lives in **svec** space: per block, the lower
triangle traversed row-major ((0,0),(1,0),(1,1),(2,0),...), off-diagonal
entries scaled by sqrt(2) so that <A,B> over symmetric matrices equals the
svec dot product (reference: src/kernels/vec_mat_conversion.cu:5,
README.md "Input format").
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from cuadmm_tpu_torch.io import txt as txtio


def svec_len_of_block(blk_type: str, n: int) -> int:
    """svec length of one block: n(n+1)/2 for PSD, n for a free vector
    (reference: src/problem.cu:27-38; 'u' blocks per README.md block table)."""
    if blk_type == "s":
        return n * (n + 1) // 2
    if blk_type == "u":
        return n
    raise ValueError(f"unknown block type {blk_type!r}")


@dataclasses.dataclass
class Problem:
    """An SDP in svec form: min <C,X> s.t. A X = b, X in product cone.

    Attributes:
      blk: list of (type, size); type 's' = PSD block, 'u' = free vector.
      At_rows/At_cols/At_vals: COO of A^T (vec_len x con_num), sorted by
        (col, row) i.e. constraint-major -- the order reference
        COO_to_CSC produces (src/utils/io.cu:203-257).
      b_indices/b_vals: sparse rhs (length con_num).
      C_indices/C_vals: sparse cost in svec form (length vec_len).
      X0/y0/S0: optional warm starts (dense, unscaled).
      sig0: optional warm-start sigma (reference: sig.txt read at
        src/problem.cu:82 / test/duo_solver_test.hpp:46).
    """

    blk: List[Tuple[str, int]]
    con_num: int
    At_rows: np.ndarray
    At_cols: np.ndarray
    At_vals: np.ndarray
    b_indices: np.ndarray
    b_vals: np.ndarray
    C_indices: np.ndarray
    C_vals: np.ndarray
    X0: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    S0: Optional[np.ndarray] = None
    sig0: Optional[float] = None
    name: str = ""

    @property
    def vec_len(self) -> int:
        return sum(svec_len_of_block(t, n) for t, n in self.blk)

    @property
    def mat_num(self) -> int:
        return len(self.blk)

    @property
    def At_nnz(self) -> int:
        return len(self.At_vals)

    def validate(self) -> List[str]:
        """Sanity warnings, mirroring reference src/problem.cu:58-72."""
        warnings = []
        if self.At_nnz:
            if int(self.At_rows.max()) != self.vec_len - 1:
                warnings.append(
                    "the largest row index in At differs from the svec length"
                )
            if int(self.At_cols.max()) != self.con_num - 1:
                warnings.append(
                    "the largest column index in At differs from the constraint count"
                )
        if self.X0 is not None and len(self.X0) != self.vec_len:
            raise ValueError("warm-start X length does not match the vector length")
        if self.y0 is not None and len(self.y0) != self.con_num:
            raise ValueError("warm-start y length does not match con_num")
        if self.S0 is not None and len(self.S0) != self.vec_len:
            raise ValueError("warm-start S length does not match the vector length")
        return warnings

    def dense_b(self) -> np.ndarray:
        out = np.zeros(self.con_num)
        out[self.b_indices] = self.b_vals
        return out

    def dense_C(self) -> np.ndarray:
        out = np.zeros(self.vec_len)
        out[self.C_indices] = self.C_vals
        return out

    @staticmethod
    def from_txt(prefix: str, warm_start: bool = False, name: str = "") -> "Problem":
        """Load a problem directory (reference: src/problem.cu:11-83).

        ``prefix`` is a directory path (trailing slash optional).
        """
        p = prefix if prefix.endswith(os.sep) else prefix + os.sep
        blk = txtio.read_blk(p + "blk.txt")

        X0 = y0 = S0 = sig0 = None
        if warm_start:
            X0 = txtio.read_dense_vector(p + "X.txt")
            y0 = txtio.read_dense_vector(p + "y.txt")
            S0 = txtio.read_dense_vector(p + "S.txt")
            con_num = len(y0)
            # Warm-start sigma (reference: src/problem.cu:82 reads sig.txt
            # alongside X/y/S; test/duo_solver_test.hpp:46).
            if os.path.exists(p + "sig.txt"):
                sig0 = float(txtio.read_dense_vector(p + "sig.txt")[0])
        else:
            con_num = int(txtio.read_dense_vector(p + "con_num.txt")[0])

        rows, cols, vals = txtio.read_coo_matrix(p + "At.txt")
        rows, cols, vals = txtio.coo_sort(rows, cols, vals, order="col-major")
        b_idx, b_vals = txtio.read_sparse_vector(p + "b.txt")
        C_idx, C_vals = txtio.read_sparse_vector(p + "C.txt")

        prob = Problem(
            blk=blk,
            con_num=con_num,
            At_rows=rows,
            At_cols=cols,
            At_vals=vals,
            b_indices=b_idx,
            b_vals=b_vals,
            C_indices=C_idx,
            C_vals=C_vals,
            X0=X0,
            y0=y0,
            S0=S0,
            sig0=sig0,
            name=name or os.path.basename(os.path.normpath(prefix)),
        )
        for w in prob.validate():
            import warnings as _warnings

            _warnings.warn(f"{prefix}: {w}")
        return prob

    def to_txt(self, prefix: str) -> None:
        """Write the problem as a TXT directory (inverse of from_txt)."""
        os.makedirs(prefix, exist_ok=True)
        p = prefix if prefix.endswith(os.sep) else prefix + os.sep
        txtio.write_blk(p + "blk.txt", self.blk)
        txtio.write_dense_vector(p + "con_num.txt", np.array([self.con_num]))
        txtio.write_coo_matrix(p + "At.txt", self.At_rows, self.At_cols, self.At_vals)
        txtio.write_sparse_vector(p + "b.txt", self.b_indices, self.b_vals)
        txtio.write_sparse_vector(p + "C.txt", self.C_indices, self.C_vals)
        if self.X0 is not None:
            txtio.write_dense_vector(p + "X.txt", self.X0)
        if self.y0 is not None:
            txtio.write_dense_vector(p + "y.txt", self.y0)
        if self.S0 is not None:
            txtio.write_dense_vector(p + "S.txt", self.S0)

    @staticmethod
    def from_dense(
        blk: List[Tuple[str, int]],
        A: np.ndarray,
        b: np.ndarray,
        C: np.ndarray,
        name: str = "",
    ) -> "Problem":
        """Build a problem from a dense constraint matrix A (con_num x vec_len)
        and dense b, C vectors. Convenience for tests and generators."""
        con_num, vec_len = A.shape
        rows, cols = np.nonzero(A.T)
        vals = A.T[rows, cols]
        rows = rows.astype(np.int32)
        cols = cols.astype(np.int32)
        rows, cols, vals = txtio.coo_sort(rows, cols, vals, order="col-major")
        b = np.asarray(b, dtype=np.float64)
        C = np.asarray(C, dtype=np.float64)
        b_idx = np.nonzero(b)[0].astype(np.int32)
        C_idx = np.nonzero(C)[0].astype(np.int32)
        return Problem(
            blk=list(blk),
            con_num=con_num,
            At_rows=rows,
            At_cols=cols,
            At_vals=np.ascontiguousarray(vals, dtype=np.float64),
            b_indices=b_idx,
            b_vals=b[b_idx],
            C_indices=C_idx,
            C_vals=C[C_idx],
            name=name,
        )
