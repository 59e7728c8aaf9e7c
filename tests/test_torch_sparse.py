"""Bucketed-ELL products of the port against cuadmm_tpu.ops.sparse (f64)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jnp = pytest.importorskip("jax.numpy")

from cuadmm_tpu.ops import sparse as jsparse

from cuadmm_tpu_torch.ops import sparse as tsparse
from cuadmm_tpu_torch.structure import BlockStructure

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL = 1e-12  # same f64 products, summed in another order


def _mixed_case(rng):
    """PSD blocks of two sizes plus a free block (pool != svec), as in
    tests/test_ops.py::test_compact_aat_matvec."""
    blk = [("s", 5)] * 40 + [("s", 13)] * 10 + [("u", 7)]
    st = BlockStructure(blk, "pow2", 64, 0)
    con, nnz = 150, 600
    rows = rng.integers(0, st.vec_len, nnz)
    cols = rng.integers(0, con, nnz)
    key = cols.astype(np.int64) * st.vec_len + rows
    _, keep = np.unique(key, return_index=True)
    return st, con, rows[keep], cols[keep]


def _skewed_case(rng):
    """A 1000-entry constraint next to singletons and empty rows in both
    directions (tests/test_ops.py::test_spmv_skewed_row_populations); one
    free block, so pool coordinates are svec coordinates."""
    con, vec = 700, 900
    st = BlockStructure([("u", vec)], "pow2", 64, 0)
    rows = np.concatenate([rng.integers(0, vec, 1000), rng.integers(0, vec, 800)])
    cols = np.concatenate([np.full(1000, 3), rng.integers(0, con, 800)])
    key = cols.astype(np.int64) * vec + rows
    _, keep = np.unique(key, return_index=True)
    return st, con, rows[keep], cols[keep]


def _dense_pattern_case(rng):
    """Most pool slots written by A^T (out_perm placement, no compact A)."""
    st = BlockStructure([("s", 3)] * 6, "exact", 64, 0)
    con = 40
    A = rng.standard_normal((con, st.vec_len))
    rows, cols = np.nonzero(A.T)
    return st, con, rows, cols


@pytest.mark.parametrize("case", [_mixed_case, _skewed_case, _dense_pattern_case])
def test_spmv_and_aat_match_jax(case):
    rng = np.random.default_rng(7)
    st, con, rows, cols = case(rng)
    vals = rng.standard_normal(len(rows))
    sj = jsparse.build_sparse_a_pool(rows, cols, vals, con, st, jnp.float64)
    stt = tsparse.build_sparse_a_pool(rows, cols, vals, con, st, torch.float64, CPU)
    assert (stt.a_idx_compact is None) == (sj.a_idx_compact is None)
    assert (stt.at.out_pos is None) == (sj.at.out_pos is None)
    for t in (stt.a, stt.at):
        assert all(i.dtype == torch.int64 for i in t.idx)

    x = rng.standard_normal(st.pool_len)
    y = rng.standard_normal(con)
    ax = tsparse.spmv_a(stt, torch.as_tensor(x)).numpy()
    aty = tsparse.spmv_at(stt, torch.as_tensor(y)).numpy()
    aaty = tsparse.aat_matvec(stt, torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(ax, np.asarray(jsparse.spmv_a(sj, jnp.asarray(x))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(aty, np.asarray(jsparse.spmv_at(sj, jnp.asarray(y))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        aaty, np.asarray(jsparse.aat_matvec(sj, jnp.asarray(y))), rtol=0, atol=ATOL
    )
    # And against the host product in svec coordinates.
    A = sp.csr_matrix((vals, (cols, rows)), shape=(con, st.vec_len))
    np.testing.assert_allclose(aaty, A @ (A.T @ y), rtol=0, atol=1e-10)


@pytest.mark.parametrize("case", [_skewed_case, _dense_pattern_case])
def test_build_sparse_a_matches_jax(case):
    """build_sparse_a (svec coordinates, no pool): identical tables and the
    same products."""
    rng = np.random.default_rng(8)
    st, con, rows, cols = case(rng)
    vals = rng.standard_normal(len(rows))
    sj = jsparse.build_sparse_a(rows, cols, vals, con, st.vec_len, jnp.float64)
    stt = tsparse.build_sparse_a(rows, cols, vals, con, st.vec_len, torch.float64, CPU)
    assert stt.a_idx_compact is None and (stt.con_num, stt.vec_len) == (con, st.vec_len)
    for mine, theirs in ((stt.a, sj.a), (stt.at, sj.at)):
        for a, b in zip(mine.idx + mine.vals, theirs.idx + theirs.vals):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for f in ("out_perm", "out_pos", "out_src"):
            a, b = getattr(mine, f), getattr(theirs, f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    y = rng.standard_normal(con)
    np.testing.assert_allclose(
        tsparse.aat_matvec(stt, torch.as_tensor(y)).numpy(),
        np.asarray(jsparse.aat_matvec(sj, jnp.asarray(y))), rtol=0, atol=ATOL,
    )


def test_normalize_rows_identical():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 50, 300)
    cols = rng.integers(0, 20, 300)
    vals = rng.standard_normal(300) * 3
    nj, vj = jsparse.normalize_rows(rows, cols, vals, 20)
    nt, vt = tsparse.normalize_rows(rows, cols, vals, 20)
    np.testing.assert_array_equal(nj, nt)
    np.testing.assert_array_equal(vj, vt)
