"""MOSEK-format importer (SDP subset).

Replaces the reference's MATLAB chain mosek -> sedumi -> SDPT3 -> TXT
(reference: examples/mosek_to_txt.m:1-19,
examples/utils/convert_mosek2sedumi.m). Imports a MOSEK ``prob`` struct
(as stored in the reference's examples/SPOT/data/MOSEK/*.mat) directly:

  minimize    sum_j <barc_j, Xbar_j> + c'x
  subject to  blc_i <= sum_j <bara_ij, Xbar_j> + (a x)_i <= buc_i,
              Xbar_j PSD with dim bardim_j

Supported subset: equality constraints (blc == buc) and PSD variables;
scalar variables x become a free ('u') block when their bounds are
infinite. bara/barc give the LOWER triangle; an off-diagonal entry stands
for both symmetric positions, so its svec coefficient is val * sqrt(2).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from cuadmm_tpu_torch.io.conewise import SQRT2
from cuadmm_tpu_torch.problem import Problem


def _field(struct, name, default=None):
    if hasattr(struct, "_fieldnames"):
        return getattr(struct, name) if name in struct._fieldnames else default
    if isinstance(struct, dict):
        return struct.get(name, default)
    return default


def mosek_to_problem(prob, name: str = "mosek") -> Problem:
    bardim = np.atleast_1d(np.asarray(_field(prob, "bardim"))).astype(int).ravel()
    blc = np.asarray(_field(prob, "blc"), dtype=np.float64).ravel()
    buc = np.asarray(_field(prob, "buc"), dtype=np.float64).ravel()
    if not np.allclose(blc, buc, equal_nan=True):
        raise NotImplementedError("only equality-constrained problems (blc == buc)")
    b = blc
    con_num = len(b)

    a = _field(prob, "a")
    a = sp.csc_matrix(a) if a is not None else sp.csc_matrix((con_num, 0))
    n_scalar = a.shape[1]
    c_lin = np.asarray(_field(prob, "c", np.zeros(n_scalar)), dtype=np.float64).ravel()
    if n_scalar and len(c_lin) != n_scalar:
        c_lin = np.zeros(n_scalar)

    # Block layout: PSD blocks first (matching bardim order), then one free
    # block for the scalar variables.
    blk: List[Tuple[str, int]] = [("s", int(n)) for n in bardim]
    bar_offsets = np.zeros(len(bardim) + 1, dtype=np.int64)
    for j, n in enumerate(bardim):
        bar_offsets[j + 1] = bar_offsets[j] + n * (n + 1) // 2
    svec_bar_len = int(bar_offsets[-1])
    vec_len = svec_bar_len + n_scalar
    if n_scalar:
        blx = _field(prob, "blx")
        bux = _field(prob, "bux")
        for bound in (blx, bux):
            if bound is not None:
                barr = np.asarray(bound, dtype=np.float64).ravel()
                if barr.size and np.any(np.isfinite(barr)):
                    raise NotImplementedError(
                        "bounded scalar variables are not supported (free only)"
                    )
        blk.append(("u", n_scalar))

    def tri_entries(subj, subk, subl, val):
        subj = np.asarray(subj).astype(int).ravel() - 1  # block (1-based)
        subk = np.asarray(subk).astype(int).ravel() - 1  # row
        subl = np.asarray(subl).astype(int).ravel() - 1  # col
        val = np.asarray(val, dtype=np.float64).ravel()
        k = np.maximum(subk, subl)
        l = np.minimum(subk, subl)
        pos = bar_offsets[subj] + k * (k + 1) // 2 + l
        sv = np.where(k == l, val, val * SQRT2)
        return pos, sv

    # Cost.
    C_vec = np.zeros(vec_len)
    barc = _field(prob, "barc")
    if barc is not None and np.asarray(_field(barc, "val", [])).size:
        pos, sv = tri_entries(
            _field(barc, "subj"), _field(barc, "subk"), _field(barc, "subl"),
            _field(barc, "val"),
        )
        np.add.at(C_vec, pos, sv)
    if n_scalar:
        C_vec[svec_bar_len:] = c_lin

    # Constraints.
    bara = _field(prob, "bara")
    if bara is not None and np.asarray(_field(bara, "val", [])).size:
        subi = np.asarray(_field(bara, "subi")).astype(int).ravel() - 1
        pos, sv = tri_entries(
            _field(bara, "subj"), _field(bara, "subk"), _field(bara, "subl"),
            _field(bara, "val"),
        )
    else:
        subi = np.zeros(0, dtype=int)
        pos = np.zeros(0, dtype=np.int64)
        sv = np.zeros(0)
    if n_scalar and a.nnz:
        acoo = a.tocoo()
        subi = np.concatenate([subi, acoo.row])
        pos = np.concatenate([pos, svec_bar_len + acoo.col])
        sv = np.concatenate([sv, acoo.data])

    at = sp.csc_matrix((sv, (pos, subi)), shape=(vec_len, con_num))
    at.sum_duplicates()
    at_coo = at.tocoo()
    rows = at_coo.row.astype(np.int32)
    cols = at_coo.col.astype(np.int32)
    vals = at_coo.data
    order = np.lexsort((rows, cols))

    b_idx = np.nonzero(b)[0].astype(np.int32)
    C_idx = np.nonzero(C_vec)[0].astype(np.int32)
    return Problem(
        blk=blk,
        con_num=con_num,
        At_rows=rows[order],
        At_cols=cols[order],
        At_vals=vals[order],
        b_indices=b_idx,
        b_vals=b[b_idx],
        C_indices=C_idx,
        C_vals=C_vec[C_idx],
        name=name,
    )


def load_mosek_mat(path: str, name: str = "") -> Problem:
    """Load a MOSEK 'prob' struct from a .mat file."""
    import scipy.io as sio

    m = sio.loadmat(path, squeeze_me=True, struct_as_record=False)
    if "prob" not in m:
        raise ValueError(f"{path}: no 'prob' struct")
    return mosek_to_problem(m["prob"], name=name or path.rsplit("/", 1)[-1])
