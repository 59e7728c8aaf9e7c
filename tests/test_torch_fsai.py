"""The port's copy of the FSAI preconditioner against cuadmm_tpu.ops.fsai.

``build_fsai`` and ``_pattern`` are numpy/scipy code copied as they are, so
the same AA^T must give identical matrices; ``fsai_tables`` builds the
port's ELL tables of G and G^T, whose products reproduce G^T (G r).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jnp = pytest.importorskip("jax.numpy")

from cuadmm_tpu.ops import fsai as jfsai
from cuadmm_tpu.ops import sparse as jsparse

from cuadmm_tpu_torch.ops import fsai as tfsai
from cuadmm_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _aat(seed: int = 11, con: int = 96, vec_len: int = 400):
    """tests/test_ops.py::test_cg_fsai_preconditioner's AA^T, with
    duplicated rows so that it is singular."""
    A = sp.random(con, vec_len, density=0.2, random_state=seed, format="csr")
    A = sp.vstack([A, A[:8]]).tocsr()
    return (A @ A.T).tocsr()


def _assert_same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("power,cap", [(1, 64), (2, 64), (2, 8), (2, 0)])
def test_pattern_and_build_fsai_identical(power, cap):
    aat = _aat()
    _assert_same_csr(tfsai._pattern(aat, power, cap), jfsai._pattern(aat, power, cap))
    _assert_same_csr(
        tfsai.build_fsai(aat, eps_rel=1e-10, pattern_power=power, cap=cap),
        jfsai.build_fsai(aat, eps_rel=1e-10, pattern_power=power, cap=cap),
    )


def test_fsai_factor_properties():
    """G lower triangular, diag(G AA^T G^T) = 1 on the rows solved exactly
    (tests/test_ops.py::test_cg_fsai_preconditioner)."""
    aat = _aat(con=96)[:96, :96].tocsr()  # nonsingular: no duplicated rows
    G = tfsai.build_fsai(aat, eps_rel=1e-10)
    Gd = G.toarray()
    assert np.allclose(Gd, np.tril(Gd))
    assert np.allclose((G @ aat @ G.T).diagonal(), 1.0, atol=1e-6)


def test_fsai_tables_apply_g_transpose_g():
    """The port's tables give G^T (G r) to 1e-12 and hold the same index and
    value arrays as the JAX package's."""
    G = tfsai.build_fsai(_aat(), eps_rel=1e-10)
    g_t, gt_t = tfsai.fsai_tables(G, torch.float64, CPU)
    g_j, gt_j = jfsai.fsai_tables(G, jnp.float64)
    for mine, theirs in ((g_t, g_j), (gt_t, gt_j)):
        assert len(mine.idx) == len(theirs.idx)
        for a, b in zip(mine.idx + mine.vals, theirs.idx + theirs.vals):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(mine.out_perm.numpy(), np.asarray(theirs.out_perm))
    r = np.random.default_rng(3).standard_normal(G.shape[0])
    z = tsparse._ell_matvec(gt_t, tsparse._ell_matvec(g_t, torch.as_tensor(r))).numpy()
    z_ref = G.T @ (G @ r)
    assert np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref) < 1e-12
    z_j = np.asarray(jsparse._ell_matvec(gt_j, jsparse._ell_matvec(g_j, jnp.asarray(r))))
    np.testing.assert_allclose(z, z_j, rtol=0, atol=1e-12 * np.abs(z_ref).max())


def test_fsai_zero_rows():
    """tests/test_ops.py::test_fsai_zero_rows: an all-zero AA^T row gets a
    finite entry, not a 1e30 spike."""
    d = np.ones(8)
    d[3] = 0.0
    aat = sp.diags(d, format="csr")
    Gd = tfsai.build_fsai(aat, eps_rel=1e-8).toarray()
    assert np.all(np.isfinite(Gd)) and Gd[3, 3] < 1e8
    _assert_same_csr(tfsai.build_fsai(aat, eps_rel=1e-8), jfsai.build_fsai(aat, eps_rel=1e-8))
