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


def _quasar(n_poses: int, seed: int = 0):
    """QUASAR with ``n_poses`` poses as a JAX-package Problem: b = (N+1) e_0,
    C a seeded symmetric matrix."""
    from cuadmm_tpu.models.quasar import quasar_constraints
    from cuadmm_tpu.problem import Problem

    rows, cols, vals, con_num, n = quasar_constraints(n_poses)
    m = np.random.default_rng(seed).standard_normal((n, n))
    r, c = np.tril_indices(n)
    return Problem(
        blk=[("s", n)], con_num=con_num, At_rows=rows, At_cols=cols, At_vals=vals,
        b_indices=np.array([0]), b_vals=np.array([n_poses + 1.0]),
        C_indices=np.arange(len(r)), C_vals=((m + m.T) / 2)[r, c] * np.where(r == c, 1.0, np.sqrt(2.0)),
    )


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
    assert isinstance(neq.factor, tchol.InverseFactor) and neq.inv_l is neq.factor.inv_l
    assert neq.factor.inv_l.dtype == torch.float32 and neq.factor.inv_l.shape[0] % 128 == 0
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
    timings = {}
    budget = jax_limits().dense_a_budget if dense_a else 0
    l, eps_used = tchol._device_factorize(r, c, v, 4, 10, 1e-12, CPU, dense_a_budget=budget, timings=timings)
    assert timings["aat"] == ("device" if dense_a else "host")
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


def _upper_is_zero(m: torch.Tensor) -> bool:
    return bool(torch.equal(m.triu(1), torch.zeros_like(m)))


@pytest.mark.parametrize("mode", ["precond", "split"])
def test_inverse_factor_is_exactly_lower_triangular(mode):
    """K1 reads only the lower triangle of the inverse factor and its plain
    version reads the square, so the factor is exactly zero above the
    diagonal, for precond and for split's coupled prefix, and still M = inv(L)."""
    if mode == "precond":
        prob = _chordal()
        vals, _, sa = _operands(prob)
        neq = _port_solver(prob, vals, sa, applies=2)
        con = prob.con_num
    else:
        r, c, v, con, vec_len = _split_at()
        sa = tsparse.build_sparse_a(r, c, v, con, vec_len, torch.float64, CPU)
        neq = tchol.build_normal_solver(r, c, v, con, vec_len, sa, "split", torch.float64, CPU, applies=2)
        con = neq.factor.p
    m = (neq.factor.prefix if mode == "split" else neq.factor).inv_l
    assert m.dtype == torch.float32 and m.shape[0] % 128 == 0 and m.is_contiguous() and _upper_is_zero(m)
    assert not m[con:].any() and not m[:, con:].any()
    l = torch.linalg.inv(m[:con, :con].double())  # L, lower triangular up to rounding
    assert float(l.triu(1).abs().max()) < 1e-6 * float(l.abs().max())


@pytest.mark.parametrize("mode", ["precond", "split"])
@pytest.mark.parametrize("build", ["cpu", "accelerator"])
def test_convert_keeps_only_the_lower_triangle(mode, build, monkeypatch):
    """From the JAX package's CPU build (an f64 factor, inverted here) and
    from its accelerator build (a padded f32 inverse, here with ones written
    above its diagonal), the carried-over inverse factor is exactly zero
    above the diagonal and keeps the JAX lower triangle bit for bit."""
    import dataclasses

    from cuadmm_tpu_torch import convert

    prob = _quasar(3) if mode == "split" else _chordal()
    vals, sa_j, _ = _operands(prob)
    args = (prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len)
    if build == "accelerator":
        monkeypatch.setattr(jchol.jax, "default_backend", lambda: "gpu")
    neq_j = jchol.build_normal_solver(*args, sa_j, mode, jnp.float64, applies=2)
    monkeypatch.undo()
    if build == "accelerator":
        inv_j = np.asarray(neq_j.inv_l, np.float32)
        assert inv_j.shape[0] % 128 == 0
        neq_j = dataclasses.replace(neq_j, inv_l=inv_j + np.triu(np.ones_like(inv_j), 1))
    else:
        assert neq_j.inv_l is None and neq_j.chol_l is not None
    neq_t = convert.normal_solver_from_numpy(neq_j, CPU)
    if build == "cpu" and mode == "split":  # the f64 prefix factor is carried as it is
        assert isinstance(neq_t.factor.prefix, tchol.CholFactor) and neq_t.inv_l is None
        return
    m = (neq_t.factor.prefix if mode == "split" else neq_t.factor).inv_l
    assert m.dtype == torch.float32 and m.is_contiguous() and _upper_is_zero(m)
    if build == "accelerator":
        assert np.array_equal(m.numpy(), np.tril(inv_j))


@pytest.mark.parametrize("mode", ["sharded"])
def test_unported_modes_raise(mode):
    """Every mode is ported; ``sharded`` needs a mesh, and without one
    raises as the JAX package's does (cuadmm_tpu/ops/chol.py:1189)."""
    r, c, v, _ = _semidefinite_at()
    st = BlockStructure([("u", 10)], "pow2", 64, 0)
    sa = tsparse.build_sparse_a_pool(r, c, v, 4, st, torch.float64, CPU)
    with pytest.raises(ValueError, match="requires a device mesh"):
        tchol.build_normal_solver(r, c, v, 4, 10, sa, mode, torch.float64, CPU)


def _auto_cases():
    """(name, JAX-package Problem, dense_chol_max): split with 12 coupled
    rows, split with none (plain max-cut), split on QUASAR's prefix, more
    than 1024 coupled rows (precond on an accelerator, dense on the CPU)
    and the same past dense_chol_max (cg on the CPU)."""
    from cuadmm_tpu.models.maxcut import maxcut_sdp, random_graph

    n = 120
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    big, _ = maxcut_chordal(W + W.T)
    return [
        ("certified", _certified(), 32768),
        ("maxcut", maxcut_sdp(random_graph(30, p=0.2, seed=1)), 32768),
        ("quasar", _quasar(3), 32768),
        ("chordal", big, 32768),
        ("chordal_past_ceiling", big, 1000),
    ]


def _auto_modes(monkeypatch, accelerator: bool) -> list:
    """The mode each package's ``auto`` builds for every _auto_cases problem;
    ``accelerator`` makes the JAX package take its accelerator rule (its
    split and precond builds run on the CPU all the same)."""
    out = []
    for name, prob, dcm in _auto_cases():
        _, vals = tsparse.normalize_rows(prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num)
        args = (prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len)
        if accelerator:
            if dcm < prob.con_num:  # past the ceiling: the JAX package would build Pallas tiles
                continue
            monkeypatch.setattr(jchol.jax, "default_backend", lambda: "gpu")
        sa_j = jsparse.build_sparse_a(*args, jnp.float64)
        mode_j = jchol.build_normal_solver(*args, sa_j, "auto", jnp.float64, dense_chol_max=dcm).mode
        monkeypatch.undo()
        mode_t, _, _ = tchol._resolve_auto(*args, torch.float64, accelerator, dcm)
        if not accelerator:
            sa_t = tsparse.build_sparse_a(*args, torch.float64, CPU)
            neq = tchol.build_normal_solver(*args, sa_t, "auto", torch.float64, CPU, dense_chol_max=dcm)
            assert neq.mode == mode_t
        out.append((name, mode_j, mode_t))
    return out


def test_auto_resolves_like_jax_on_an_accelerator(monkeypatch):
    """auto under the JAX package's accelerator rule (cuadmm_tpu/ops/chol.py:
    781-801): split when few rows couple, else precond."""
    got = _auto_modes(monkeypatch, accelerator=True)
    assert [m for _, m, _ in got] == ["split", "split", "split", "precond"]
    for name, mode_j, mode_t in got:
        assert mode_t == mode_j, name


def test_auto_resolves_like_jax_on_the_cpu(monkeypatch):
    """auto on the CPU builds what the JAX package builds there: split,
    dense (f64 state) and, past dense_chol_max, cg (:841-842)."""
    got = _auto_modes(monkeypatch, accelerator=False)
    assert [m for _, m, _ in got] == ["split", "split", "split", "dense", "cg"]
    for name, mode_j, mode_t in got:
        assert mode_t == mode_j, name


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
        assert neq_t.factor.layout == tuple(neq_j.packed_layout) and "packed_factorize" in timings
        assert neq_t.factor.tiles.dtype == torch.float32
    else:
        bw, perm = jchol._rcm_bandwidth(jchol.build_aat_host(*args))
        assert neq_t.factor.layout == tuple(neq_j.band_layout) and timings["band_bw"] == bw
        assert timings["band_layout"].startswith(f"nb={neq_t.factor.layout.nb} ")
        if make is _chain_shuffled:
            assert neq_t.factor.perm is not None
        if neq_t.factor.perm is None:
            assert neq_j.band_perm is None and np.array_equal(perm, np.arange(con))
        else:
            np.testing.assert_array_equal(neq_t.factor.perm.numpy(), perm)
            np.testing.assert_array_equal(neq_t.factor.inv_perm.numpy(), np.asarray(neq_j.band_inv_perm))
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


def jax_limits():
    """The JAX package's numbers as the port's CardLimits: its ceilings
    (cuadmm_tpu/ops/chol.py:99-109), its dense-A limit (:496) and its band
    block model (cuadmm_tpu/ops/tri_stream.py:463-478: tile bytes at 800
    GB/s plus 3 us a tile step), all sized for a 16 GB TPU chip."""
    from cuadmm_tpu_torch.ops.limits import CardLimits

    return CardLimits(
        total_bytes=16 * 10**9, packed_max_con=jchol.PACKED_MAX_CON, band_max_bytes=jchol.BAND_MAX_BYTES,
        dense_a_budget=6 * 1024**3, precond_max_n_pad=32768,  # no such check: its dense_chol_max
        band_model=lambda T, B, nb: T * B * B * 4 / 800e9 + T * 3e-6,
    )


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
    """The port's rule, given the JAX package's numbers, picks what the JAX
    package picks; the CPU takes cg whatever the numbers."""
    expect = _jax_accelerator_rule(con_num, bw, n_devices)
    assert tchol.past_ceiling_mode(con_num, bw, True, n_devices, jax_limits()) == expect
    assert tchol.past_ceiling_mode(con_num, bw, False, n_devices, jax_limits()) == "cg"
    assert tchol.past_ceiling_mode(con_num, bw, False, n_devices, None) == "cg"
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
        assert neq_t.factor.layout == tuple(neq_j.packed_layout)
        np.testing.assert_array_equal(neq_t.factor.tiles.numpy(), np.asarray(neq_j.packed_tiles, np.float32))
    else:
        assert neq_t.factor.layout == tuple(neq_j.band_layout)
        np.testing.assert_array_equal(neq_t.factor.tiles.numpy(), np.asarray(neq_j.band_tiles, np.float32))
        for mine, theirs in ((neq_t.factor.perm, neq_j.band_perm), (neq_t.factor.inv_perm, neq_j.band_inv_perm)):
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


# ----------------------------------------------------------------------
# dense, split, cg and host modes.
# ----------------------------------------------------------------------


def _random_at(rng, vec_len, con_num, density):
    """tests/test_ops.py::random_sparse_at."""
    mask = rng.random((vec_len, con_num)) < density
    At = np.where(mask, rng.standard_normal((vec_len, con_num)), 0.0)
    rows, cols = np.nonzero(At)
    return rows.astype(np.int32), cols.astype(np.int32), At[rows, cols], At


def _svec_operands(r, c, v, con, vec_len):
    return (
        jsparse.build_sparse_a(r, c, v, con, vec_len, jnp.float64),
        tsparse.build_sparse_a(r, c, v, con, vec_len, torch.float64, CPU),
    )


@pytest.mark.parametrize("mode", ["dense", "inv", "split", "cg", "host"])
def test_normal_solver_modes_match_jax_and_numpy(mode):
    """tests/test_ops.py::test_normal_solver_modes on both packages: the
    port's solve within 1e-6 of a dense numpy solve and within 1e-9 of the
    JAX package's (whose precond and split factors are f64 on the CPU; the
    port's f32 ones are refined 4 times)."""
    rng = np.random.default_rng(7)
    vec_len, con = 50, 12
    r, c, v, At = _random_at(rng, vec_len, con, 0.4)
    sa_j, sa_t = _svec_operands(r, c, v, con, vec_len)
    kw = dict(cg_tol=1e-14, cg_max_iter=500, applies=4)
    neq_j = jchol.build_normal_solver(r, c, v, con, vec_len, sa_j, mode, jnp.float64, **kw)
    neq_t = tchol.build_normal_solver(r, c, v, con, vec_len, sa_t, mode, torch.float64, CPU, **kw)
    assert neq_t.mode == neq_j.mode
    rhs = rng.standard_normal(con)
    y_t = neq_t.solve(torch.as_tensor(rhs)).numpy()
    y_j = np.asarray(neq_j.solve(jnp.asarray(rhs)))
    expected = np.linalg.solve(At.T @ At + 1e-15 * np.eye(con), rhs)
    np.testing.assert_allclose(y_t, expected, rtol=1e-6, atol=1e-8)
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-9


def test_dense_semidefinite_solve_is_finite():
    """tests/test_ops.py::test_normal_solver_semidefinite: the f64 factor of
    a singular AA^T builds through the jitter ladder."""
    r, c, v, _ = _semidefinite_at()
    sa = tsparse.build_sparse_a(r, c, v, 4, 10, torch.float64, CPU)
    neq = tchol.build_normal_solver(r, c, v, 4, 10, sa, "dense", torch.float64, CPU)
    assert neq.factor.chol_l.dtype == torch.float64 and neq.eps_used >= 1e-14
    assert torch.isfinite(neq.solve(torch.ones(4, dtype=torch.float64))).all()


def _split_at():
    """Even rows touch private svec columns only; odd rows share columns, so
    the coupled set is the odd rows and [S, S^c] is not the identity."""
    rng = np.random.default_rng(4)
    con, shared = 20, 12
    rows, cols, vals = [], [], []
    for i in range(con):
        if i % 2:
            picks = rng.choice(shared, size=3, replace=False)
        else:
            picks = [shared + i, shared + con + i]
        rows.extend(picks)
        cols.extend([i] * len(picks))
        vals.extend(rng.standard_normal(len(picks)))
    return np.array(rows), np.array(cols), np.array(vals), con, shared + 2 * con


@pytest.mark.parametrize("case", ["permuted", "quasar", "diagonal"])
def test_split_matches_jax(case):
    """The split build's pieces against the JAX package's (p, permutations,
    tail inverse diagonal identical), the prefix through the f32 inverse
    factor, and the solve within 1e-9 of the JAX package's f64 one."""
    if case == "permuted":
        r, c, v, con, vec_len = _split_at()
    else:
        if case == "quasar":
            prob = _quasar(3)
        else:
            from cuadmm_tpu.models.maxcut import maxcut_sdp, random_graph

            prob = maxcut_sdp(random_graph(30, p=0.2, seed=1))
        _, v = tsparse.normalize_rows(prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num)
        r, c, con, vec_len = prob.At_rows, prob.At_cols, prob.con_num, prob.vec_len
    sa_j, sa_t = _svec_operands(r, c, v, con, vec_len)
    # 6 sweeps: the permuted case's prefix has lambda_min 0.024, so each
    # sweep of the f32 factor (jitter 1e-4 of the mean diagonal) contracts
    # the residual only by 1e-2.
    neq_j = jchol.build_normal_solver(r, c, v, con, vec_len, sa_j, "split", jnp.float64, applies=6)
    neq_t = tchol.build_normal_solver(r, c, v, con, vec_len, sa_t, "split", torch.float64, CPU, applies=6)
    p = neq_t.factor.p
    assert p == neq_t.split_p == neq_j.split_p == {"permuted": 10, "quasar": 31, "diagonal": 0}[case]
    np.testing.assert_array_equal(neq_t.factor.tail_inv_diag.numpy(), np.asarray(neq_j.tail_inv_diag))
    for mine, theirs in ((neq_t.factor.perm, neq_j.split_perm), (neq_t.factor.inv_perm, neq_j.split_inv_perm)):
        assert (mine is None) == (theirs is None) == (case != "permuted")
        if mine is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    if p:
        prefix = neq_t.factor.prefix
        assert isinstance(prefix, tchol.InverseFactor) and neq_t.inv_l is prefix.inv_l
        assert prefix.inv_l.dtype == torch.float32 and prefix.inv_l.shape[0] == 128
    else:
        assert neq_t.factor.prefix is None and neq_t.inv_l is None and neq_t.factor.buffer() is None
    rng = np.random.default_rng(3)
    rhs = np.array(jsparse.spmv_a(sa_j, jnp.asarray(rng.standard_normal(vec_len))))
    warm = rng.standard_normal(con)
    y_t = neq_t.solve(torch.as_tensor(rhs), warm=torch.as_tensor(warm)).numpy()
    y_j = np.asarray(neq_j.solve(jnp.asarray(rhs), warm=jnp.asarray(warm)))
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-9
    assert float(neq_t.residual_norm(torch.as_tensor(rhs), torch.as_tensor(y_t))) < 1e-10


def test_split_past_dense_chol_max_raises():
    r, c, v, con, vec_len = _split_at()
    sa = tsparse.build_sparse_a(r, c, v, con, vec_len, torch.float64, CPU)
    with pytest.raises(ValueError, match="coupled set is 10 rows"):
        tchol.build_normal_solver(r, c, v, con, vec_len, sa, "split", torch.float64, CPU, dense_chol_max=9)


def test_split_calibrates_on_quasar():
    prob = _quasar(3)
    vals, _, sa = _operands(prob)
    timings = {}
    neq = tchol.build_normal_solver(
        prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len, sa, "auto", torch.float64, CPU,
        applies=0, timings=timings,
    )
    assert neq.mode == "split" and neq.factor.perm is None and 1 <= neq.applies <= tchol.CALIBRATE_MAX_APPLIES
    assert "split_factorize" in timings and "calibrate" in timings
    rhs = tsparse.aat_matvec(sa, torch.as_tensor(np.random.default_rng(1).standard_normal(prob.con_num)))
    assert float(neq.residual_norm(rhs, neq.solve(rhs))) < 1e-10


def test_block_jacobi_inv_identical():
    """A prefix of dense blocks (the last block with off-diagonal entries
    ends it) and the identity on the last block's padding, as f32."""
    A = sp.random(70, 90, density=0.05, random_state=3, format="csr")
    A = sp.vstack([A, sp.eye(30, 90, k=60, format="csr")]).tocsr()  # 30 diagonal rows at the end
    aat = (A @ A.T).tocsr()
    bj_j = np.asarray(jchol._block_jacobi_inv(aat, 100, 32, 1e-10, jnp.float32))
    bj_t = tchol._block_jacobi_inv(aat, 100, 32, 1e-10, torch.float32, CPU)
    assert bj_t.dtype == torch.float32 and bj_t.shape == bj_j.shape == (3, 32, 32)
    np.testing.assert_array_equal(bj_t.numpy(), bj_j)
    assert tchol._block_jacobi_inv(sp.eye(40, format="csr"), 40, 16, 1e-10, torch.float32, CPU) is None


@pytest.mark.parametrize("precond", ["block_jacobi", "fsai", "jacobi"])
def test_cg_matches_jax(precond):
    """tests/test_ops.py::test_cg_block_jacobi_and_tol and
    ::test_cg_fsai_preconditioner on both packages: the dtype-aware default
    tolerance, the preconditioner pieces identical, residual < 1e-8 and the
    solves within 1e-10 of each other."""
    rng = np.random.default_rng(9)
    vec_len, con = 400, 96
    r, c, v, _ = _random_at(rng, vec_len, con, 0.2)
    sa_j, sa_t = _svec_operands(r, c, v, con, vec_len)
    kw = dict(cg_block_jacobi=32, cg_precond=precond)
    neq_j = jchol.build_normal_solver(r, c, v, con, vec_len, sa_j, "cg", jnp.float64, **kw)
    timings = {}
    neq_t = tchol.build_normal_solver(r, c, v, con, vec_len, sa_t, "cg", torch.float64, CPU, timings=timings, **kw)
    cg = neq_t.factor
    assert cg.tol == neq_j.cg_tol == 64 * np.finfo(np.float64).eps
    np.testing.assert_array_equal(cg.inv_diag.numpy(), np.asarray(neq_j.inv_diag))
    assert (cg.bj_inv is None) == (neq_j.bj_inv is None) == (precond != "block_jacobi")
    assert (cg.fsai_g is None) == (neq_j.fsai_g is None) == (precond != "fsai")
    if precond == "block_jacobi":
        np.testing.assert_array_equal(cg.bj_inv.numpy(), np.asarray(neq_j.bj_inv))
    if precond == "fsai":
        assert timings["fsai_nnz"] > con and "fsai_build" in timings
    rhs = rng.standard_normal(con)
    y_t = neq_t.solve(torch.as_tensor(rhs))
    assert float(neq_t.residual_norm(torch.as_tensor(rhs), y_t)) < 1e-8
    y_j = np.asarray(neq_j.solve(jnp.asarray(rhs)))
    assert np.linalg.norm(y_t.numpy() - y_j) / np.linalg.norm(y_j) < 1e-10


def test_cg_auto_falls_back_to_block_jacobi(monkeypatch):
    rng = np.random.default_rng(9)
    r, c, v, _ = _random_at(rng, 400, 96, 0.2)
    sa = tsparse.build_sparse_a(r, c, v, 96, 400, torch.float64, CPU)

    def broken(*a, **k):
        raise np.linalg.LinAlgError("singular local system")

    monkeypatch.setattr(tchol, "build_fsai", broken)
    neq = tchol.build_normal_solver(r, c, v, 96, 400, sa, "cg", torch.float64, CPU, cg_block_jacobi=32)
    assert neq.factor.fsai_g is None and neq.factor.bj_inv.shape == (3, 32, 32)
    with pytest.raises(np.linalg.LinAlgError):
        tchol.build_normal_solver(r, c, v, 96, 400, sa, "cg", torch.float64, CPU, cg_precond="fsai")


def _cg_operands():
    rng = np.random.default_rng(12)
    A = sp.random(80, 200, density=0.05, random_state=5, format="csr")
    aat = (A @ A.T).tocsr() + 1e-3 * sp.eye(80, format="csr")
    inv_diag = 1.0 / aat.diagonal()
    coo = aat.tocoo()
    tbl_j = jsparse._build_ell(coo.row, coo.col, coo.data, 80, 80, jnp.float64)
    tbl_t = tsparse._build_ell(coo.row, coo.col, coo.data, 80, 80, torch.float64, CPU)
    return rng.standard_normal(80), rng.standard_normal(80), inv_diag, tbl_j, tbl_t


@pytest.mark.parametrize("max_iter", [3, 500])
def test_pcg_blocks_return_what_the_unblocked_loop_returns(max_iter):
    """Blocks of 16, 5 and 1 steps (1: the flag read after every step, the
    unblocked loop) give bitwise the same x and step count; the JAX
    package's while_loop agrees to 1e-12, including when max_iter stops
    it mid-block."""
    rhs, x0, inv_diag, tbl_j, tbl_t = _cg_operands()
    d_t = torch.as_tensor(inv_diag)
    op = lambda v: tsparse._ell_matvec(tbl_t, v)
    outs = {
        k: tchol._pcg(op, torch.as_tensor(rhs), lambda r: r * d_t, torch.as_tensor(x0), 1e-13, max_iter, block=k)
        for k in (16, 5, 1)
    }
    x1, steps1, _ = outs[1]
    assert steps1 == 3 if max_iter == 3 else 3 < steps1 < 80
    for k, (x, steps, waits) in outs.items():
        # One flag read per block, the last one in the block that took the
        # last step.
        assert torch.equal(x, x1) and steps == steps1 and waits == -(-steps1 // k)
    d_j = jnp.asarray(inv_diag)
    x_j = np.asarray(jchol._pcg(
        lambda v: jsparse._ell_matvec(tbl_j, v), jnp.asarray(rhs), lambda r: r * d_j,
        jnp.asarray(x0), 1e-13, max_iter,
    ))
    assert np.linalg.norm(x1.numpy() - x_j) / np.linalg.norm(x_j) < 1e-12


def test_pcg_zero_rhs_stays_finite():
    """rhs = 0 from x0 = 0: r is exactly zero, no step is kept, and the
    discarded steps' 0/0 never reaches x."""
    _, _, inv_diag, _, tbl_t = _cg_operands()
    d_t = torch.as_tensor(inv_diag)
    zero = torch.zeros(80, dtype=torch.float64)
    x, steps, waits = tchol._pcg(lambda v: tsparse._ell_matvec(tbl_t, v), zero, lambda r: r * d_t, zero, 1e-14, 400)
    assert steps == 0 and waits == 1 and torch.equal(x, zero)


def test_host_mode_solves_and_warns_on_cuda(monkeypatch):
    """host: scipy's LU of AA^T + eps I; the solve copies rhs to the host
    and back. Building it for a CUDA device warns (the factorization itself
    is the same host code, so the check runs here with the device's kind
    faked)."""
    rng = np.random.default_rng(7)
    r, c, v, At = _random_at(rng, 50, 12, 0.4)
    sa = tsparse.build_sparse_a(r, c, v, 12, 50, torch.float64, CPU)
    with pytest.warns(UserWarning, match="host"):
        tchol.build_normal_solver(r, c, v, 12, 50, sa, "host", torch.float64, torch.device("cuda"))
    neq = tchol.build_normal_solver(r, c, v, 12, 50, sa, "host", torch.float64, CPU)
    rhs = rng.standard_normal(12)
    np.testing.assert_allclose(neq.solve(torch.as_tensor(rhs)).numpy(), np.linalg.solve(At.T @ At, rhs), rtol=1e-9)


@pytest.mark.parametrize("mode", ["dense", "split", "cg"])
def test_convert_carries_dense_split_and_cg_solvers(mode):
    from cuadmm_tpu_torch import convert

    prob = _quasar(3)
    vals, sa_j, _ = _operands(prob)
    args = (prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len)
    neq_j = jchol.build_normal_solver(*args, sa_j, mode, jnp.float64, applies=3)
    neq_t = convert.normal_solver_from_numpy(neq_j, CPU)
    assert neq_t.mode == mode and neq_t.applies == neq_j.applies
    if mode in ("dense", "split"):  # the JAX package's f64 CPU factor
        chol_l = (neq_t.factor.prefix if mode == "split" else neq_t.factor).chol_l
        np.testing.assert_array_equal(chol_l.numpy(), np.asarray(neq_j.chol_l))
        assert chol_l.dtype == torch.float64 and neq_t.inv_l is None
    if mode == "split":
        assert neq_t.factor.p == neq_j.split_p == 31 and neq_t.factor.perm is None
        np.testing.assert_array_equal(neq_t.factor.tail_inv_diag.numpy(), np.asarray(neq_j.tail_inv_diag))
    if mode == "cg":
        assert (neq_t.factor.tol, neq_t.factor.max_iter) == (neq_j.cg_tol, neq_j.cg_max_iter)
        assert neq_t.factor.fsai_g is not None and neq_t.factor.aat_tbl.out_len == prob.con_num
    rhs = np.array(jsparse.spmv_a(sa_j, jnp.asarray(np.random.default_rng(6).standard_normal(sa_j.vec_len))))
    y_t = neq_t.solve(torch.as_tensor(rhs)).numpy()
    y_j = np.asarray(neq_j.solve(jnp.asarray(rhs)))
    assert np.linalg.norm(y_t - y_j) / np.linalg.norm(y_j) < 1e-10
