"""The port's precond normal solver against cuadmm_tpu.ops.chol (f64 state).

The port factorizes in f32 and applies the inverted factor (the JAX
package's accelerator route) on every device; the JAX package on the CPU
keeps an f64 factor and solves with cho_solve. Both refine against the
exact f64 AA^T, so their solves agree far below the refinement target.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jnp = pytest.importorskip("jax.numpy")

from cuadmm_tpu.ops import chol as jchol
from cuadmm_tpu.ops import sparse as jsparse

from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.ops import chol as tchol
from cuadmm_tpu_torch.ops import sparse as tsparse
from cuadmm_tpu_torch.structure import BlockStructure

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _certified():
    prob, *_ = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    return prob


def _chordal():
    n = 40
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3)], [1, 2, 3], shape=(n, n))
    prob, _ = maxcut_chordal(W + W.T)
    return prob


def _operands(prob):
    """Row-normalized A triplets and both packages' f64 pool-coordinate A."""
    _, vals = tsparse.normalize_rows(prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num)
    st = BlockStructure(prob.blk, "pow2", 64, 0)
    args = (prob.At_rows, prob.At_cols, vals, prob.con_num, st)
    return (
        vals,
        jsparse.build_sparse_a_pool(*args, jnp.float64),
        tsparse.build_sparse_a_pool(*args, torch.float64, CPU),
    )


def _port_solver(prob, vals, sa, applies):
    return tchol.build_normal_solver(
        prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len, sa,
        "precond", torch.float64, CPU, applies=applies,
    )


@pytest.mark.parametrize("make", [_certified, _chordal], ids=["certified", "chordal"])
def test_calibrated_precond_reaches_target(make):
    prob = make()
    vals, _, sa = _operands(prob)
    neq = _port_solver(prob, vals, sa, applies=0)
    assert neq.mode == "precond" and 1 <= neq.applies <= 6
    assert neq.inv_l.dtype == torch.float32 and neq.inv_l.shape[0] % 128 == 0
    # A fresh consistent rhs of the calibration probe's kind, (AA^T) v.
    rng = np.random.default_rng(1)
    rhs = tsparse.aat_matvec(sa, torch.as_tensor(rng.standard_normal(prob.con_num)))
    y = neq.solve(rhs)
    assert float(neq.residual_norm(rhs, y)) < 1e-10


@pytest.mark.parametrize("make", [_certified, _chordal], ids=["certified", "chordal"])
def test_solve_matches_jax_precond(make):
    prob = make()
    vals, sa_j, sa_t = _operands(prob)
    neq_j = jchol.build_normal_solver(
        prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len, sa_j,
        "precond", jnp.float64, applies=4,
    )
    neq_t = _port_solver(prob, vals, sa_t, applies=4)
    assert neq_j.mode == neq_t.mode == "precond" and neq_j.eps_used == neq_t.eps_used
    rng = np.random.default_rng(2)
    rhs = np.array(jsparse.spmv_a(sa_j, jnp.asarray(rng.standard_normal(sa_j.vec_len))))
    warm = rng.standard_normal(prob.con_num)
    yj = np.asarray(neq_j.solve(jnp.asarray(rhs), warm=jnp.asarray(warm)))
    yt = neq_t.solve(torch.as_tensor(rhs), warm=torch.as_tensor(warm)).numpy()
    assert np.linalg.norm(yt - yj) / np.linalg.norm(yj) < 1e-9


def _semidefinite_at():
    """Constraint 2 duplicates constraint 0: AA^T is singular
    (tests/test_ops.py::test_normal_solver_semidefinite)."""
    At = np.zeros((10, 4))
    At[0, 0], At[1, 1], At[0, 2], At[2, 3] = 1.0, 2.0, 1.0, 1.0
    r, c = np.nonzero(At)
    return r, c, At[r, c], At.T


@pytest.mark.parametrize("dense_a", [True, False], ids=["device_dense_a", "host_aat"])
def test_eps_escalation_on_semidefinite_aat(dense_a):
    r, c, v, A = _semidefinite_at()
    limit = 6 * 1024**3 if dense_a else 0
    l, eps_used = tchol._device_factorize(r, c, v, 4, 10, 1e-12, CPU, dense_a_build_limit=limit)
    assert eps_used > 1e-12  # f32 cannot see 1e-12 of jitter: it had to escalate
    assert torch.isfinite(l).all()
    aat = A @ A.T
    scale = max(np.trace(aat) / 4, 1.0)
    l64 = l.double().numpy()
    np.testing.assert_allclose(l64 @ l64.T, aat + eps_used * scale * np.eye(4), atol=1e-5)


def test_semidefinite_solve_is_finite():
    r, c, v, _ = _semidefinite_at()
    st = BlockStructure([("u", 10)], "pow2", 64, 0)
    sa = tsparse.build_sparse_a_pool(r, c, v, 4, st, torch.float64, CPU)
    neq = tchol.build_normal_solver(r, c, v, 4, 10, sa, "precond", torch.float64, CPU)
    assert torch.isfinite(neq.solve(torch.ones(4, dtype=torch.float64))).all()


def test_tri_inv_matches_jax():
    rng = np.random.default_rng(5)
    n = 300
    a = rng.standard_normal((n, n))
    l = np.linalg.cholesky(a @ a.T + n * np.eye(n))
    mj = np.asarray(jchol._tri_inv(jnp.asarray(l), block=64))  # the blocked path
    mt = tchol._tri_inv(torch.as_tensor(l)).numpy()
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["dense", "split", "packed", "banded", "sharded", "cg", "host"])
def test_unported_modes_raise(mode):
    r, c, v, _ = _semidefinite_at()
    st = BlockStructure([("u", 10)], "pow2", 64, 0)
    sa = tsparse.build_sparse_a_pool(r, c, v, 4, st, torch.float64, CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tchol.build_normal_solver(r, c, v, 4, 10, sa, mode, torch.float64, CPU)


def test_auto_resolves_like_jax_on_an_accelerator():
    """auto: split when few rows couple, else precond on CUDA and dense on
    the CPU in f64 (cuadmm_tpu/ops/chol.py:781-801); only precond runs, and
    auto raises before it touches the sparse A."""
    def auto(prob, **kw):
        tchol.build_normal_solver(
            prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num, prob.vec_len, None,
            "auto", torch.float64, CPU, **kw,
        )

    with pytest.raises(NotImplementedError, match="'split'"):
        auto(_certified())  # 12 coupled rows
    n = 120
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    big, _ = maxcut_chordal(W + W.T)  # > 1024 coupled rows
    with pytest.raises(NotImplementedError, match="'dense'"):
        auto(big)
    with pytest.raises(NotImplementedError, match="packed"):
        auto(big, dense_chol_max=1000)
