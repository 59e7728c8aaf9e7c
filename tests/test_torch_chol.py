"""The port's precond, packed and banded normal solvers against
cuadmm_tpu.ops.chol (f64 state).

The port factorizes in f32 (the JAX package's accelerator route) on every
device; the JAX package on the CPU keeps an f64 factor. Both refine
against the exact f64 AA^T, so their solves agree far below the
refinement target (where AA^T is singular, A^T y does; y itself is unique
only up to null(A^T)).
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


@pytest.mark.parametrize("mode", ["dense", "split", "sharded", "cg", "host"])
def test_unported_modes_raise(mode):
    r, c, v, _ = _semidefinite_at()
    st = BlockStructure([("u", 10)], "pow2", 64, 0)
    sa = tsparse.build_sparse_a_pool(r, c, v, 4, st, torch.float64, CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tchol.build_normal_solver(r, c, v, 4, 10, sa, mode, torch.float64, CPU)


def test_auto_resolves_like_jax_on_an_accelerator():
    """auto: split when few rows couple, else precond on CUDA and dense on
    the CPU in f64 (cuadmm_tpu/ops/chol.py:781-801), and past
    dense_chol_max cg on the CPU (:841-842); those modes raise before they
    touch the sparse A."""
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
    with pytest.raises(NotImplementedError, match="CG, FSAI"):
        auto(big, dense_chol_max=1000)


# ----------------------------------------------------------------------
# Packed and banded modes (past dense_chol_max).
# ----------------------------------------------------------------------


def _rank_deficient():
    """tests/test_tri_stream.py::test_packed_mode_normal_solver's A: 20
    duplicated rows, so AA^T is singular."""
    A = sp.random(100, 300, density=0.1, random_state=2, format="csr")
    return sp.vstack([A, A[:20]]).tocsr()


def _chain_shuffled():
    """tests/test_tri_stream.py::_chain_A(400) with its rows shuffled: RCM
    has to recover the band."""
    rng = np.random.default_rng(3)
    rows, cols, vals = [], [], []
    n, coupling, per = 400, 30, 6
    for i in range(n):
        for k in rng.choice(coupling + per, size=4, replace=False):
            rows.append(i)
            cols.append(2 * i + int(k))
            vals.append(rng.standard_normal())
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, 2 * n + coupling + per))
    return A[np.random.default_rng(7).permutation(n)].tocsr()


def _a_operands(A):
    """Triplets of a raw A (vec side = A's columns) and both packages' A."""
    con, vec_len = A.shape
    coo = A.tocoo()
    r, c, v = coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data
    st = BlockStructure([("u", vec_len)], "pow2", 64, 0)
    return (r, c, v, con, vec_len), jsparse.build_sparse_a(r, c, v, con, vec_len, jnp.float64), \
        tsparse.build_sparse_a_pool(r, c, v, con, st, torch.float64, CPU)


@pytest.mark.parametrize("make", [_rank_deficient, _chain_shuffled], ids=["rank_deficient", "chain_shuffled"])
@pytest.mark.parametrize("mode", ["packed", "banded"])
def test_packed_and_banded_solvers_match_jax(mode, make):
    A = make()
    args, sa_j, sa_t = _a_operands(A)
    con = args[3]
    neq_j = jchol.build_normal_solver(*args, sa_j, mode, jnp.float64, applies=4)
    timings = {}
    neq_t = tchol.build_normal_solver(*args, sa_t, mode, torch.float64, CPU, applies=4, timings=timings)
    assert neq_t.mode == mode and neq_t.applies == 4
    if mode == "packed":
        assert neq_t.packed_layout == tuple(neq_j.packed_layout) and "packed_factorize" in timings
        assert neq_t.packed_tiles.dtype == torch.float32
    else:
        bw, perm = jchol._rcm_bandwidth(jchol.build_aat_host(*args))
        assert neq_t.band_layout == tuple(neq_j.band_layout) and timings["band_bw"] == bw
        assert timings["band_layout"].startswith(f"nb={neq_t.band_layout[3]} ")
        if make is _chain_shuffled:
            assert neq_t.band_perm is not None
        if neq_t.band_perm is None:
            assert neq_j.band_perm is None and np.array_equal(perm, np.arange(con))
        else:
            np.testing.assert_array_equal(neq_t.band_perm.numpy(), perm)
            np.testing.assert_array_equal(neq_t.band_inv_perm.numpy(), np.asarray(neq_j.band_inv_perm))
    rng = np.random.default_rng(5)
    rhs = A @ rng.standard_normal(A.shape[1])  # consistent
    y_t = neq_t.solve(torch.as_tensor(rhs))
    assert float(neq_t.residual_norm(torch.as_tensor(rhs), y_t)) < 1e-8
    y_j = np.asarray(neq_j.solve(jnp.asarray(rhs)))
    # A^T y is unique even where AA^T is singular; y itself only where it
    # is not (with duplicated rows, the f32 and f64 factors leave different
    # components in null(A^T), ~1e-3 of y here).
    at_t, at_j = A.T @ y_t.numpy(), A.T @ y_j
    assert np.linalg.norm(at_t - at_j) / np.linalg.norm(at_j) < 1e-6
    if make is _chain_shuffled:
        assert np.linalg.norm(y_t.numpy() - y_j) / np.linalg.norm(y_j) < 1e-6


@pytest.mark.parametrize("mode", ["packed", "banded"])
def test_calibrated_packed_and_banded_reach_target(mode):
    args, _, sa_t = _a_operands(_chain_shuffled())
    neq = tchol.build_normal_solver(*args, sa_t, mode, torch.float64, CPU, applies=0)
    assert 1 <= neq.applies <= tchol.CALIBRATE_MAX_APPLIES
    rhs = tsparse.aat_matvec(sa_t, torch.as_tensor(np.random.default_rng(1).standard_normal(args[3])))
    assert float(neq.residual_norm(rhs, neq.solve(rhs))) < 1e-10


def _jax_accelerator_rule(con_num, bw, n_mesh):
    """The JAX package's choice past dense_chol_max on an accelerator
    (cuadmm_tpu/ops/chol.py:809-840), with its own layouts and constants."""
    from cuadmm_tpu.ops import tri_stream as jts

    blay = jts.make_band_layout(con_num, bw)
    band_bytes = blay.T * blay.block * blay.block * 4
    packed_bytes = jts.make_layout(con_num).T * 1024 * 1024 * 4 if con_num <= jchol.PACKED_MAX_CON else None
    if packed_bytes is not None and packed_bytes <= band_bytes * 1.15:
        return "packed"
    if band_bytes <= jchol.BAND_MAX_BYTES:
        return "banded"
    if packed_bytes is not None:
        return "packed"
    return "sharded" if n_mesh > 1 else "cg"


@pytest.mark.parametrize(
    "con_num,bw",
    [
        (68350, 4),  # the 20x120 grid max-cut: banded
        (68350, 68349), (40000, 39999), (33000, 30000),  # no band: packed
        (33000, 10), (112028, 1615), (154256, 20512),  # bands
        (200000, 60000), (80000, 79999),  # neither fits: cg, or sharded on a mesh
        (73000, 20000), (73001, 20000),  # around PACKED_MAX_CON
    ],
)
@pytest.mark.parametrize("n_devices", [1, 4])
def test_past_ceiling_choice_matches_jax_rule(con_num, bw, n_devices):
    assert (tchol.PACKED_MAX_CON, tchol.BAND_MAX_BYTES) == (jchol.PACKED_MAX_CON, jchol.BAND_MAX_BYTES)
    expect = _jax_accelerator_rule(con_num, bw, n_devices)
    assert tchol.past_ceiling_mode(con_num, bw, True, n_devices) == expect
    assert tchol.past_ceiling_mode(con_num, bw, False, n_devices) == "cg"
    if (con_num, bw) == (68350, 4):
        assert expect == "banded"


def test_rcm_bandwidth_matches_jax():
    aat = (lambda A: (A @ A.T).tocsr())(_chain_shuffled())
    bw_t, perm_t = tchol._rcm_bandwidth(aat)
    bw_j, perm_j = jchol._rcm_bandwidth(aat)
    assert bw_t == bw_j < 40
    np.testing.assert_array_equal(perm_t, perm_j)


@pytest.mark.parametrize("make", [_rank_deficient, _chain_shuffled], ids=["rank_deficient", "chain_shuffled"])
@pytest.mark.parametrize("mode", ["packed", "banded"])
def test_convert_carries_packed_and_banded_solvers(mode, make):
    from cuadmm_tpu_torch import convert

    A = make()
    args, sa_j, _ = _a_operands(A)
    neq_j = jchol.build_normal_solver(*args, sa_j, mode, jnp.float64, applies=4)
    neq_t = convert.normal_solver_from_numpy(neq_j, CPU)
    assert neq_t.mode == mode and neq_t.applies == 4 and neq_t.eps_used == neq_j.eps_used
    if mode == "packed":
        assert neq_t.packed_layout == tuple(neq_j.packed_layout)
        np.testing.assert_array_equal(neq_t.packed_tiles.numpy(), np.asarray(neq_j.packed_tiles, np.float32))
    else:
        assert neq_t.band_layout == tuple(neq_j.band_layout)
        np.testing.assert_array_equal(neq_t.band_tiles.numpy(), np.asarray(neq_j.band_tiles, np.float32))
        for mine, theirs in ((neq_t.band_perm, neq_j.band_perm), (neq_t.band_inv_perm, neq_j.band_inv_perm)):
            assert (mine is None) == (theirs is None)
            if mine is not None:
                np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    rhs = A @ np.random.default_rng(6).standard_normal(A.shape[1])
    y_t = neq_t.solve(torch.as_tensor(rhs)).numpy()
    y_j = np.asarray(neq_j.solve(jnp.asarray(rhs)))
    assert np.linalg.norm(A.T @ (y_t - y_j)) / np.linalg.norm(A.T @ y_j) < 1e-6


@pytest.mark.parametrize(
    "con_num,on_accel,expect",
    [(12000, False, "dense"), (20000, False, "precond"), (25000, False, "cg"),
     (25000, True, "precond"), (40000, False, "cg")],
)
def test_auto_applies_the_jax_cpu_factor_size_guards(con_num, on_accel, expect):
    """Every row touches svec column 0, so every row couples and split is
    out; on the CPU an f64 factor past 2 GiB drops to precond and an f32
    one past 2 GiB to cg (cuadmm_tpu/ops/chol.py:843-847); past
    dense_chol_max the CPU takes cg without building AA^T."""
    rows = np.zeros(con_num, np.int64)
    cons = np.arange(con_num, dtype=np.int64)
    mode, aat, probe = tchol._resolve_auto(
        rows, cons, np.ones(con_num), con_num, 1, torch.float64, on_accel, 32768
    )
    assert mode == expect and aat is None and probe is None
