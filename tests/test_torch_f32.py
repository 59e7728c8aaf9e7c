"""The port's float32 state against cuadmm_tpu's.

One step of each package from identical f32 state (carried by
cuadmm_tpu_torch.convert), the f64 true-residual probe, whole f32 solves
and solve_escalated, the precision-stall detector and rp_hp through a
recovery, and the float64 path's info rows against values stored from the
port before the f32 path existed.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

import cuadmm_tpu
from cuadmm_tpu.models.random_sdp import random_certified_sdp
from cuadmm_tpu.solver.step import make_step as jmake_step

import cuadmm_tpu_torch
from cuadmm_tpu_torch import convert
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.solver import driver
from cuadmm_tpu_torch.solver.step import make_step as tmake_step

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP_RTOL = 1e-4  # one f32 step: the two packages round differently


def _f32_certified():
    """tests/test_solver.py:101's instance."""
    return random_certified_sdp([("s", 5), ("s", 3)], con_num=8, seed=23)


def _f32_cfg(**kw):
    base = dict(verbose=False, dtype="float32", projection="eigh", precond_applies=4, switch_admm=10**9)
    base.update(kw)
    return base


def _consts(stop_tol=1e-6, switch_admm=10**9):
    cfg = cuadmm_tpu.SolverConfig()
    return dict(stop_tol=stop_tol, switch_admm=switch_admm, sig_update_threshold=cfg.sig_update_threshold,
                sig_update_stage_1=cfg.sig_update_stage_1, sig_min=cfg.sig_min, sig_max=cfg.sig_max)


def _jax_state(s, seed=5):
    rng = np.random.default_rng(seed)
    vec, con = s.problem.vec_len, s.problem.con_num
    return s._initial_state(
        rng.standard_normal(vec) * 0.3, rng.standard_normal(con), rng.standard_normal(vec) * 0.3, 2.0
    )


@pytest.mark.parametrize("rp_hp", [False, True], ids=["rp_f32", "rp_hp"])
@pytest.mark.parametrize("mode", ["precond", "dense"])
def test_f32_step_matches_jax(mode, rp_hp):
    """One f32 step of each package from the same state: the new state and
    the info row within STEP_RTOL. rp_hp: both take Rp and errRp from the
    f64 A-product."""
    prob, *_ = _f32_certified()
    s = cuadmm_tpu.SDPSolver(prob, cuadmm_tpu.SolverConfig(normal_solver=mode, **_f32_cfg()))
    assert s.params.sparse_a.a.vals[0].dtype == jnp.float32 and s._sa_hp.a.vals[0].dtype == jnp.float64
    st = _jax_state(s)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    state_t = convert.state_from_numpy(to_np(st), CPU)
    params_t = convert.params_from_numpy(to_np(s.params), CPU)
    assert state_t.X.dtype == torch.float32 and params_t.sparse_a.a.vals[0].dtype == torch.float32
    assert params_t.neq.sparse_a.a.vals[0].dtype == torch.float64
    hp_j = (s._sa_hp, jnp.asarray(s._b_scaled, jnp.float64), jnp.asarray(s.scaling.normA, jnp.float64))
    hp_t = convert.rp_hp_from_numpy(s, CPU) if rp_hp else None
    with jax.default_matmul_precision("highest"):
        new_j, row_j = jmake_step(projection="eigh", rp_hp=hp_j if rp_hp else None, **_consts())(st, s.params)
    new_t, row_t = tmake_step(projection="eigh", rp_hp=hp_t, **_consts())(state_t, params_t, 0)
    assert row_t.dtype == torch.float32
    np.testing.assert_allclose(row_t.numpy(), np.asarray(row_j), rtol=STEP_RTOL, atol=0)
    for name in ("X", "y", "S", "Rp"):
        a, b = np.asarray(getattr(new_j, name)), getattr(new_t, name).numpy()
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=0, atol=STEP_RTOL * np.abs(a).max(), err_msg=name)


def test_true_residual_probe_matches_jax():
    """The f64 probe of errRp on the same f32 pool iterate: 1e-12."""
    prob, *_ = _f32_certified()
    j = cuadmm_tpu.SDPSolver(prob, cuadmm_tpu.SolverConfig(normal_solver="dense", **_f32_cfg()))
    t = cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(normal_solver="dense", **_f32_cfg()),
                                   device="cpu")
    assert t._sa_hp.a.vals[0].dtype == torch.float64 and t.params.sparse_a.a.vals[0].dtype == torch.float32
    # The two copies share their index tensors.
    assert all(a is b for a, b in zip(t._sa_hp.a.idx, t.params.sparse_a.a.idx))
    rng = np.random.default_rng(3)
    for _ in range(3):
        X = rng.standard_normal(t.structure.pool_len).astype(np.float32)
        ej = j._true_errRp(jnp.asarray(X))
        et = t._true_errRp(torch.as_tensor(X))
        assert abs(et - ej) <= 1e-12 * abs(ej)


def test_float32_mode():
    """tests/test_solver.py::test_float32_mode on the port, through the
    f32 calibration target."""
    prob, *_, pobj = _f32_certified()
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=25, dtype="float32", switch_admm=10**9)
    s = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu")
    assert s.dtype == torch.float32 and s.params.b.dtype == torch.float32
    res = s.solve(max_iter=6000, stop_tol=2e-4)
    assert res.converged
    assert abs(res.pobj - pobj) / (1 + abs(pobj)) < 5e-3


@pytest.mark.parametrize("method", ["eigh", "poly", "jacobi"])
def test_f32_projection_matches_jax(method):
    """The projection in f32 against the JAX package's f32 (poly with
    SIGN_SCHEDULE_F32 in both), relative to the largest entry."""
    from cuadmm_tpu.ops import projection as jproj
    from cuadmm_tpu.ops import svec as jsvec

    from cuadmm_tpu_torch.ops import projection as tproj
    from cuadmm_tpu_torch.ops import svec as tsvec
    from cuadmm_tpu_torch.structure import BlockStructure

    st = BlockStructure([("s", 1), ("s", 3), ("u", 4), ("s", 5), ("s", 7), ("s", 12)], "pow2", 64, 0)
    jm = jsvec.device_maps(st, jnp.float32)
    tm = tsvec.device_maps(st, torch.float32, CPU)
    x = np.random.default_rng(2).standard_normal(st.vec_len).astype(np.float32)
    pool = np.array(jsvec.pool_from_svec(jnp.asarray(x), jm))
    with jax.default_matmul_precision("highest"):
        pj = np.asarray(jproj.psd_project_pool(jnp.asarray(pool), jm, method=method))
    pt = tproj.psd_project_pool(torch.as_tensor(pool), tm, method=method)
    assert pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=1e-5 * np.abs(pool).max())


@pytest.mark.parametrize("mode", ["precond", "split", "packed", "banded"])
def test_f32_calibration_target_cuts_sweeps(mode):
    """Every mode with sweeps calibrates to the f32 target
    clip(0.03 stop_tol, 1e-6, 1e-5) instead of 1e-10, so it takes fewer
    sweeps than in f64 on the 4x6 grid and still solves the probe rhs to that target."""
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(4), path(6)) + sp.kron(path(4), sp.eye(6))
    prob = maxcut_chordal((W + W.T).tocsr())[0]
    ns = "auto" if mode == "split" else mode
    solvers = {
        dt: cuadmm_tpu_torch.SDPSolver(
            prob, cuadmm_tpu_torch.SolverConfig(verbose=False, dtype=dt, normal_solver=ns), device="cpu"
        )
        for dt in ("float64", "float32")
    }
    n32, n64 = solvers["float32"].params.neq, solvers["float64"].params.neq
    assert n32.mode == n64.mode == mode
    assert n32.applies < n64.applies
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(prob.con_num))
    from cuadmm_tpu_torch.ops.sparse import aat_matvec

    rhs = aat_matvec(n32.sparse_a, v)
    assert float(n32.residual_norm(rhs, n32.solve(rhs))) < 1e-5


def test_f32_cg_keeps_rhs_and_iterate_f64(monkeypatch):
    """In f32 state CG runs on f64 rhs and iterate at the f32 default
    tolerance 2e-7 (cuadmm_tpu/ops/chol.py:858-868, 1274) and the solve
    returns the state dtype."""
    from cuadmm_tpu_torch.ops import chol

    seen = []
    real = chol._pcg

    def recording(op, rhs, apply_m, x0, tol, max_iter, block=chol.CG_BLOCK):
        seen.append((rhs.dtype, x0.dtype, tol))
        return real(op, rhs, apply_m, x0, tol, max_iter, block)

    monkeypatch.setattr(chol, "_pcg", recording)
    prob, *_ = _f32_certified()
    s = cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(**_f32_cfg(normal_solver="cg")), device="cpu")
    rhs = torch.ones(prob.con_num, dtype=torch.float32)
    y = s.params.neq.solve(rhs, warm=torch.zeros_like(rhs))
    assert y.dtype == torch.float32 and seen == [(torch.float64, torch.float64, 2e-7)]


def test_solve_escalated_f32_then_f64_tail():
    """tests/test_solver.py::test_solve_escalated_f32_then_f64_tail on the
    port, same instance and budgets. At 1e-4 the port's f32 solve converges
    on its own (the JAX package's f32 diverges on the CPU and its ladder
    restarts in f64). At 1e-7 the f32 phase stops at F32_CERT_TOL and the
    f64 tail warm-starts from it: the JAX ladder would spend the whole
    budget in f32 when f32 neither diverges nor reaches feasibility."""
    prob, _, _, _, opt = random_certified_sdp([("s", 6)] * 8, con_num=200, seed=3)
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=100, dtype="float32")
    res = cuadmm_tpu_torch.solve_escalated(prob, cfg, max_iter=20000, stop_tol=1e-4, device="cpu")
    assert res.converged and abs(res.pobj - opt) / (1 + abs(opt)) < 1e-2
    calls = []
    solve = driver.SDPSolver.solve

    def recording(self, **kw):
        out = solve(self, **kw)
        calls.append((self.config.dtype, kw["stop_tol"], out.iterations))
        return out

    driver.SDPSolver.solve = recording
    try:
        res2 = cuadmm_tpu_torch.solve_escalated(prob, cfg, max_iter=60000, stop_tol=1e-7, device="cpu")
    finally:
        driver.SDPSolver.solve = solve
    assert [c[:2] for c in calls] == [("float32", driver.F32_CERT_TOL), ("float64", 1e-7)]
    assert res2.iterations == calls[0][2] + calls[1][2]
    assert res2.converged, (res2.errRp, res2.errRd, res2.relgap)
    assert max(res2.errRp, res2.errRd, res2.relgap) < 1e-7
    assert abs(res2.pobj - opt) / (1 + abs(opt)) < 1e-5


def test_precision_stall_on_a_crafted_trail():
    row = lambda rp, rd: np.array([0.0, 0.0, rp, rd, 1e-2, 1.0, 1.0, 1.0])
    trail = []
    # Ten checks fill the trail; the eleventh with a flat KKT and feasibility
    # met is a stall.
    assert not any(driver.precision_stall(trail, np.array([1e-3, 2e-3]), row(1e-7, 1e-7), 1e-6) for _ in range(10))
    assert driver.precision_stall(trail, np.array([1e-3]), row(1e-7, 1e-7), 1e-6)
    assert len(trail) == driver.STALL_WINDOW
    # Progress of 2% or more over the window is no stall.
    trail = [1e-3 * 0.99**k for k in range(10)]
    assert not driver.precision_stall(trail, np.array([1e-3 * 0.99**10]), row(1e-7, 1e-7), 1e-6)
    # Nor is a flat trail while feasibility is not yet met.
    trail = [1e-3] * 10
    assert not driver.precision_stall(trail, np.array([1e-3]), row(2e-6, 1e-7), 1e-6)


def _record_steps(monkeypatch) -> list:
    """Each make_step call of the driver: (projection, rp_hp on)."""
    seen = []
    make = driver.make_step

    def recording(**kw):
        seen.append((kw["projection"], kw["rp_hp"] is not None))
        return make(**kw)

    monkeypatch.setattr(driver, "make_step", recording)
    return seen


def _flat_trail(monkeypatch):
    """The stall detector fed a flat, feasible trail whatever the solve does."""
    real = driver.precision_stall
    flat = lambda trail, kkt, last, tol: real(trail, np.array([1.0]), np.zeros(8), tol)
    monkeypatch.setattr(driver, "precision_stall", flat)


def test_stall_detector_switches_to_rp_hp_then_stops(monkeypatch):
    """On a flat trail the first stall (the 11th check) switches the step
    to rp_hp, which then runs; the second (11 checks later) ends the solve
    with the precision-floor message."""
    prob, *_ = _f32_certified()
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=5, normal_solver="dense",
                                        dtype="float32", projection="eigh", switch_admm=10**9)
    s = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu")
    seen = _record_steps(monkeypatch)
    _flat_trail(monkeypatch)
    res = s.solve(max_iter=1000, stop_tol=1e-9)
    assert seen == [("eigh", False), ("eigh", True)]
    assert res.iterations == 2 * (driver.STALL_WINDOW + 1) * 5 and not res.converged
    assert "stalled at the float32 precision floor" in res.message
    # A float64 solve has no stall detector.
    s64 = cuadmm_tpu_torch.SDPSolver(prob, cfg.replace(dtype="float64"), device="cpu")
    assert s64.solve(max_iter=200, stop_tol=1e-9).iterations == 200


def test_rp_hp_survives_recovery_and_probation(monkeypatch):
    """Once the stall detector turned rp_hp on, a divergence recovery (eigh
    for the probation window) and the projection's return both keep it:
    the JAX driver drops it at both (cuadmm_tpu/solver/driver.py:523, 580)."""
    prob, *_ = _f32_certified()
    check_every = 4
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=check_every, normal_solver="precond",
                                        dtype="float32", projection="jacobi", switch_admm=10**9)
    s = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu")
    seen = _record_steps(monkeypatch)
    real = driver.precision_stall
    calls = []

    def stall_once(trail, kkt, last, tol):
        calls.append(1)
        if len(calls) == 1:  # first check: a stall; rp_hp goes on
            return True
        if len(calls) == 2:  # poison the factor: the next chunk diverges
            bad = dataclasses.replace(good.factor, inv_l=torch.full_like(good.factor.inv_l, float("nan")))
            s.params = dataclasses.replace(s.params, neq=dataclasses.replace(good, factor=bad))
        return False

    good = s.params.neq
    monkeypatch.setattr(driver, "precision_stall", stall_once)
    restart = driver.SDPSolver._recovery_restart

    def restart_and_repair(self, state, level):
        out = restart(self, state, level)
        self.params = dataclasses.replace(self.params, neq=good)
        return out

    monkeypatch.setattr(driver.SDPSolver, "_recovery_restart", restart_and_repair)
    res = s.solve(max_iter=10 * check_every, stop_tol=1e-9)
    assert res.recoveries == 1 and not res.diverged
    assert seen == [("jacobi", False), ("jacobi", True), ("eigh", True), ("jacobi", True)]


F64_CASES = {
    "certified-precond": ("certified", dict(normal_solver="precond", projection="eigh")),
    "certified-auto": ("certified", dict(normal_solver="auto", projection="eigh")),
    "grid-jacobi-packed": ("grid", dict(normal_solver="packed", projection="jacobi", pack_to=16)),
    "grid-poly-banded": ("grid", dict(normal_solver="banded", projection="poly")),
    "grid-cg": ("grid", dict(normal_solver="cg", projection="eigh")),
}


@pytest.mark.parametrize("case", list(F64_CASES))
def test_f64_info_rows_unchanged(case):
    """The float64 path's info rows, bit for bit, as the port gave them
    before the f32 path and the instance axis existed (stored from that
    commit by running the same configuration for 40 iterations, the switch
    to ADMM at 20)."""
    stored = json.loads((Path(__file__).parent / "data" / "torch_f64_info_rows.json").read_text())
    assert set(F64_CASES) == set(stored)
    which, kw = F64_CASES[case]
    if which == "certified":
        prob, *_ = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    else:
        path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
        W = sp.kron(sp.eye(4), path(6)) + sp.kron(path(4), sp.eye(6))
        prob = maxcut_chordal((W + W.T).tocsr())[0]
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=10, switch_admm=20, **kw)
    r = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu").solve(max_iter=40, stop_tol=0.0)
    for f, vals in stored[case].items():
        assert [float(v).hex() for v in r.info[f]] == vals, f
