"""The whole port slice against cuadmm_tpu's SDPSolver (f64, precond).

Both solvers run the same problem with ``normal_solver="precond"``, the
projection and ``precond_applies=4`` pinned. Info rows agree to rtol 1e-6:
the port's normal solve applies an f32 inverse factor with f64 refinement
where the JAX package on the CPU uses an f64 cho_solve, and 300
iterations carry the difference along.
"""

import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

import cuadmm_tpu
from cuadmm_tpu.models.chordal import maxcut_chordal
from cuadmm_tpu.models.random_sdp import random_certified_sdp

import cuadmm_tpu_torch

torch.set_num_threads(1)

FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig")


def _certified():
    prob, *_ = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    return prob


def _chordal():
    n = 60
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    prob, _ = maxcut_chordal(W + W.T)
    return prob


def _grid(rows=4, cols=6):
    """Max-cut on the 4-neighbour rows x cols grid graph: mixed block sizes."""
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    prob, _ = maxcut_chordal((W + W.T).tocsr())
    return prob


def _both(prob, **cfg):
    kw = dict(verbose=False, normal_solver="precond", projection="eigh", precond_applies=4)
    kw.update(cfg)
    j = cuadmm_tpu.SDPSolver(prob, cuadmm_tpu.SolverConfig(**kw))
    t = cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(**kw), device="cpu")
    return j, t


@pytest.mark.parametrize("make", [_certified, _chordal], ids=["certified", "chordal"])
def test_info_rows_match_jax(make):
    j, t = _both(make(), switch_admm=150)
    rj = j.solve(max_iter=300, stop_tol=0.0)
    rt = t.solve(max_iter=300, stop_tol=0.0)
    assert rj.iterations == rt.iterations == 300
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)
    # Past the switch both return the best iterate.
    np.testing.assert_allclose(rt.X, rj.X, rtol=0, atol=1e-6 * (1 + np.abs(rj.X).max()))


def test_converged_run_stops_on_the_same_iteration():
    prob, _, _, _, opt = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    j, t = _both(prob, check_every=25, switch_admm=10**9)
    rj = j.solve(max_iter=6000, stop_tol=1e-6)
    rt = t.solve(max_iter=6000, stop_tol=1e-6)
    assert rt.converged and rj.converged
    assert rt.iterations == rj.iterations
    assert all(len(rt.info[f]) == rt.iterations for f in FIELDS)
    assert max(rt.errRp, rt.errRd, rt.relgap) < 1e-6
    assert abs(rt.pobj - opt) / (1 + abs(opt)) < 1e-4  # tests/test_solver.py:37


def test_admm_from_start_and_warm_restart():
    """switch_admm=0 (the benchmark's mode) and a re-entrant warm start."""
    j, t = _both(_certified(), check_every=20, switch_admm=0)
    rj = j.solve(max_iter=120, stop_tol=0.0)
    rt = t.solve(max_iter=120, stop_tol=0.0)
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)
    warm = dict(X0=rj.X, y0=rj.y, S0=rj.S, sig=rj.sig)
    wj = j.solve(max_iter=40, stop_tol=0.0, **warm)
    wt = t.solve(max_iter=40, stop_tol=0.0, **warm)
    for f in FIELDS:
        np.testing.assert_allclose(wt.info[f], wj.info[f], rtol=1e-6, atol=0, err_msg=f)


def test_unported_configurations_raise():
    prob = _certified()
    with pytest.raises(NotImplementedError, match="float32"):
        cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(dtype="float32"), device="cpu")
    # The Jacobi kernel's size bound: a 70x70 block fails before the factorization.
    big, *_ = random_certified_sdp([("s", 3), ("s", 70)], con_num=12, seed=3)
    with pytest.raises(NotImplementedError, match="jacobi"):
        cuadmm_tpu_torch.SDPSolver(
            big, cuadmm_tpu_torch.SolverConfig(projection="jacobi", normal_solver="precond"), device="cpu"
        )


@pytest.mark.parametrize("projection", ["jacobi", "poly"])
def test_grid_slice_matches_jax(projection):
    """The slice as a whole: a 4x6 grid max-cut (blocks of sizes 3 to 6 in
    pow2 buckets 4 and 8) through both solvers with one projection."""
    prob = _grid()
    j, t = _both(prob, projection=projection, switch_admm=25, check_every=10)
    assert len(t.structure.buckets) >= 2 and t._projection == projection
    rj = j.solve(max_iter=50, stop_tol=0.0)
    rt = t.solve(max_iter=50, stop_tol=0.0)
    assert rj.iterations == rt.iterations == 50
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)


@pytest.fixture
def cpu_tables(tmp_path, monkeypatch):
    """Both packages' dispatch tables pointed at one throwaway directory."""
    from cuadmm_tpu.ops import dispatch as jdisp

    from cuadmm_tpu_torch.ops import dispatch as tdisp

    monkeypatch.setattr(jdisp, "_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(tdisp, "_DATA_DIR", str(tmp_path))
    return tmp_path


def test_auto_per_bucket_dict_matches_jax(cpu_tables):
    """projection="auto" with a table that picks a different method for each
    of the grid's buckets: both solvers resolve the same per-bucket dict and
    run it to the same info rows."""
    rows = [
        {"n": 4, "batch": 10, "eigh_ms": 3.0, "poly_ms": 2.0, "jacobi_ms": 1.0},
        {"n": 8, "batch": 10, "eigh_ms": 3.0, "poly_ms": 1.0, "jacobi_ms": 2.0},
    ]
    with open(cpu_tables / "eig_sweep_cpu_float64.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    j, t = _both(_grid(), projection="auto", switch_admm=25, check_every=10)
    assert t._projection == j._projection == {0: "jacobi", 1: "poly"}
    rj = j.solve(max_iter=50, stop_tol=0.0)
    rt = t.solve(max_iter=50, stop_tol=0.0)
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)


def test_auto_reads_the_cpu_table_and_eig_rank_forces_eigh():
    prob = _grid()
    j, t = _both(prob, projection="auto", pack_to=8)
    assert isinstance(t._projection, dict) and t._projection == j._projection
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, normal_solver="precond", projection="jacobi", pack_to=128, eig_rank=2
    )
    s = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu")
    assert s._projection == "eigh" and not any(bk.packed for bk in s.structure.buckets)


def test_probation_window_after_recovery(monkeypatch):
    """A poisoned factor makes the first chunk non-finite; level-1 recovery
    (here also given back the good factor) runs the eigh projection for
    5 * check_every iterations, then the configured projection returns."""
    from cuadmm_tpu_torch.solver import driver, step as step_mod

    check_every = 4
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=check_every, normal_solver="precond",
        projection="jacobi", switch_admm=10**9,
    )
    s = cuadmm_tpu_torch.SDPSolver(_grid(), cfg, device="cpu")
    good = s.params.neq
    s.params = dataclasses.replace(
        s.params, neq=dataclasses.replace(good, inv_l=torch.full_like(good.inv_l, float("nan")))
    )
    restart = driver.SDPSolver._recovery_restart

    def restart_and_repair(self, state, level):
        out = restart(self, state, level)
        self.params = dataclasses.replace(self.params, neq=dataclasses.replace(good, applies=good.applies + 2))
        return out

    monkeypatch.setattr(driver.SDPSolver, "_recovery_restart", restart_and_repair)
    methods = []
    project = step_mod.psd_project_pool

    def recording(P, maps, eig_rank=None, method="eigh"):
        methods.append(method)
        return project(P, maps, eig_rank=eig_rank, method=method)

    monkeypatch.setattr(step_mod, "psd_project_pool", recording)
    res = s.solve(max_iter=1 + 7 * check_every, stop_tol=0.0)
    assert res.recoveries == 1 and not res.diverged
    assert np.all(np.isfinite(res.info["errRp"][1:]))
    # The first chunk runs jacobi and diverges at its first iteration (the
    # guard reads the chunk's rows after all of it ran). The next five chunks
    # (5 * check_every iterations) run eigh, then jacobi returns.
    k = 5 * check_every
    assert methods[:check_every] == ["jacobi"] * check_every
    assert methods[check_every : check_every + k] == ["eigh"] * k
    assert methods[check_every + k :] == ["jacobi"] * (7 * check_every - k)


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    with pytest.raises(RuntimeError, match="cuda"):
        cuadmm_tpu_torch.SDPSolver(_certified(), cuadmm_tpu_torch.SolverConfig(verbose=False))


def test_profile_trace_capture(tmp_path):
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=10, normal_solver="precond", profile_dir=str(tmp_path)
    )
    cuadmm_tpu_torch.SDPSolver(_certified(), cfg, device="cpu").solve(max_iter=30, stop_tol=0.0)
    assert (tmp_path / "chunk1.trace.json").stat().st_size > 0


def test_divergence_guard_and_recovery_levels():
    """A poisoned factor makes the first chunk non-finite. Without recovery
    the solve aborts; with it, level 1 (+2 refinement sweeps) cannot help
    and level 2 (the CG rebuild, not ported yet) raises plainly."""
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=10, normal_solver="precond", switch_admm=10**9
    )

    def poisoned(config):
        s = cuadmm_tpu_torch.SDPSolver(_certified(), config, device="cpu")
        neq = s.params.neq
        bad = dataclasses.replace(neq, inv_l=torch.full_like(neq.inv_l, float("nan")))
        s.params = dataclasses.replace(s.params, neq=bad)
        return s

    res = poisoned(cfg.replace(divergence_recovery=False)).solve(max_iter=50, stop_tol=1e-6)
    assert res.diverged and res.recoveries == 0 and res.iterations == 1
    s = poisoned(cfg)
    applies = s.params.neq.applies
    with pytest.raises(NotImplementedError, match="level 2"):
        s.solve(max_iter=50, stop_tol=1e-6)
    assert s.params.neq.applies == applies + 2  # level 1 ran first


@pytest.mark.parametrize("mode", ["packed", "banded"])
def test_grid_packed_and_banded_match_jax(mode):
    """The 8x12 grid max-cut (1,342 constraints) through both solvers with
    the tiled factor: packed B 256, nb 6; banded B 512, nb 3 under a real
    RCM permutation (natural bandwidth 1,261, RCM 4)."""
    prob = _grid(8, 12)
    assert prob.con_num == 1342
    j, t = _both(prob, normal_solver=mode, switch_admm=25, check_every=10)
    neq = t.params.neq
    assert neq.mode == j.params.neq.mode == mode
    if mode == "packed":
        assert neq.packed_layout[2:4] == (256, 6)
    else:
        assert neq.band_layout[2:5] == (512, 3, 1) and neq.band_perm is not None
        assert t.init_breakdown["neq.band_bw"] == 4
    rj = j.solve(max_iter=50, stop_tol=0.0)
    rt = t.solve(max_iter=50, stop_tol=0.0)
    assert rj.iterations == rt.iterations == 50
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)


def test_auto_past_the_ceiling_raises_cg_on_the_cpu():
    """auto past dense_chol_max resolves to cg on the CPU, as the JAX
    package does there; cg is not ported yet."""
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, dense_chol_max=1000)
    with pytest.raises(NotImplementedError, match="CG, FSAI"):
        cuadmm_tpu_torch.SDPSolver(_grid(8, 12), cfg, device="cpu")


def test_banded_level1_recovery_adds_two_sweeps():
    """Level-1 recovery adds two refinement sweeps in banded mode too (the
    JAX package's driver.py:356 skips banded; that defect is not copied).
    Poisoned band tiles: level 1 cannot help and level 2 raises."""
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=10, normal_solver="banded", switch_admm=10**9
    )
    s = cuadmm_tpu_torch.SDPSolver(_grid(), cfg, device="cpu")
    neq = s.params.neq
    assert neq.mode == "banded"
    bad = dataclasses.replace(neq, band_tiles=torch.full_like(neq.band_tiles, float("nan")))
    s.params = dataclasses.replace(s.params, neq=bad)
    with pytest.raises(NotImplementedError, match="level 2"):
        s.solve(max_iter=50, stop_tol=1e-6)
    assert s.params.neq.mode == "banded" and s.params.neq.applies == neq.applies + 2
