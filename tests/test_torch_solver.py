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
from cuadmm_tpu_torch.ops import chol as tchol
from cuadmm_tpu_torch.ops import limits as tlim

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
    """Nothing is left unported: ``sharded`` without a mesh raises as the
    JAX package's does (cuadmm_tpu/ops/chol.py:1189; tests/
    test_torch_parallel.py runs it over ranks); float32 state builds
    (tests/test_torch_f32.py runs it)."""
    prob = _certified()
    with pytest.raises(ValueError, match="requires a device mesh"):
        cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(normal_solver="sharded"), device="cpu")
    s32 = cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(dtype="float32"), device="cpu")
    assert s32.params.C.dtype == torch.float32
    # Jacobi has no size bound any more: a 70x70 block builds.
    big, *_ = random_certified_sdp([("s", 3), ("s", 70)], con_num=12, seed=3)
    t = cuadmm_tpu_torch.SDPSolver(
        big, cuadmm_tpu_torch.SolverConfig(projection="jacobi", normal_solver="precond"), device="cpu"
    )
    assert t._projection == "jacobi" and max(bk.n for bk in t.structure.buckets) == 70


def test_jacobi_bucket_past_64_builds():
    """projection="jacobi" on the 8x12 grid packed to one 128-wide bucket,
    as the JAX package takes it; only built (a full Jacobi projection at
    n = 128 takes seconds on the CPU)."""
    cfg = dict(verbose=False, normal_solver="precond", projection="jacobi", pack_to=128)
    t = cuadmm_tpu_torch.SDPSolver(_grid(8, 12), cuadmm_tpu_torch.SolverConfig(**cfg), device="cpu")
    j = cuadmm_tpu.SDPSolver(_grid(8, 12), cuadmm_tpu.SolverConfig(**cfg))
    big = [i for i, bk in enumerate(t.structure.buckets) if bk.n > 64]
    assert big and [bk.n for bk in t.structure.buckets] == [bk.n for bk in j.structure.buckets]
    assert t._projection == "jacobi"


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
    bad = dataclasses.replace(good.factor, inv_l=torch.full_like(good.factor.inv_l, float("nan")))
    s.params = dataclasses.replace(s.params, neq=dataclasses.replace(good, factor=bad))
    restart = driver.SDPSolver._recovery_restart

    def restart_and_repair(self, state, level):
        out = restart(self, state, level)
        self.params = dataclasses.replace(self.params, neq=dataclasses.replace(good, applies=good.applies + 2))
        return out

    monkeypatch.setattr(driver.SDPSolver, "_recovery_restart", restart_and_repair)
    methods = []
    project = step_mod.psd_project_pool

    def recording(P, maps, eig_rank=None, method="eigh", **kw):
        methods.append(method)
        return project(P, maps, eig_rank=eig_rank, method=method, **kw)

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


def _record_restarts(monkeypatch) -> list:
    """Wrap the recovery restart: each call appends (level, mode, applies,
    cg_max_iter) of the normal solver it leaves behind."""
    from cuadmm_tpu_torch.solver import driver

    seen = []
    restart = driver.SDPSolver._recovery_restart

    def recording(self, state, level):
        out = restart(self, state, level)
        neq = self.params.neq
        seen.append((level, neq.mode, neq.applies, getattr(neq.factor, "max_iter", None)))
        return out

    monkeypatch.setattr(driver.SDPSolver, "_recovery_restart", recording)
    return seen


def test_divergence_guard_and_recovery_levels(monkeypatch):
    """A poisoned factor makes the first chunk non-finite. Without recovery
    the solve aborts; with it, level 1 (+2 refinement sweeps) cannot help
    and level 2 rebuilds the normal solver as CG with at least 800 steps a
    solve, which runs on from the restart."""
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=10, normal_solver="precond", switch_admm=10**9
    )

    def poisoned(config):
        s = cuadmm_tpu_torch.SDPSolver(_certified(), config, device="cpu")
        neq = s.params.neq
        poisoned = dataclasses.replace(neq.factor, inv_l=torch.full_like(neq.factor.inv_l, float("nan")))
        bad = dataclasses.replace(neq, factor=poisoned)
        s.params = dataclasses.replace(s.params, neq=bad)
        return s

    res = poisoned(cfg.replace(divergence_recovery=False)).solve(max_iter=50, stop_tol=1e-6)
    assert res.diverged and res.recoveries == 0 and res.iterations == 1
    seen = _record_restarts(monkeypatch)
    s = poisoned(cfg)
    applies = s.params.neq.applies
    res = s.solve(max_iter=50, stop_tol=1e-6)
    assert seen == [(1, "precond", applies + 2, None), (2, "cg", 2, 800)]
    assert res.recoveries == 2 and not res.diverged and res.iterations == 50
    assert np.all(np.isfinite(res.info["errRp"][2:]))


def test_level2_recovery_converges_like_jax():
    """tests/test_solver.py::test_divergence_auto_recovery_broken_factor on
    the port: dense mode with an all-zero factor goes non-finite at once;
    the restarts end in the CG solver, which converges to the optimum.
    With recovery off the same factor aborts."""
    prob, *_, opt = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=25, normal_solver="dense", switch_admm=10**9
    )
    s = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu")
    neq = s.params.neq
    assert neq.mode == "dense" and neq.factor.chol_l.dtype == torch.float64
    zero = dataclasses.replace(neq, factor=tchol.CholFactor(torch.zeros_like(neq.factor.chol_l)))
    s.params = dataclasses.replace(s.params, neq=zero)
    res = s.solve(max_iter=8000, stop_tol=1e-6)
    assert res.recoveries >= 1 and s.params.neq.mode == "cg"
    assert res.converged and not res.diverged
    assert abs(res.pobj - opt) / (1 + abs(opt)) < 1e-4
    s2 = cuadmm_tpu_torch.SDPSolver(prob, cfg.replace(divergence_recovery=False), device="cpu")
    s2.params = dataclasses.replace(s2.params, neq=dataclasses.replace(s2.params.neq, factor=zero.factor))
    res2 = s2.solve(max_iter=200, stop_tol=1e-6)
    assert res2.diverged and res2.recoveries == 0


@pytest.mark.parametrize("mode", ["packed", "banded", "banded_tiles"])
def test_grid_packed_and_banded_match_jax(monkeypatch, mode):
    """The 8x12 grid max-cut (1,342 constraints) through both solvers past
    dense_chol_max: packed B 256, nb 6; banded in K3's segments form (441
    segments, the longest 18, every solver row laid out once) and, with
    that form off (``banded_tiles``: ``limits.SEGMENT_MODEL`` None), in
    its one-hop tile form at B 512, nb 3 under a real RCM permutation
    (natural bandwidth 1,261, RCM 4); the JAX package in its band tiles."""
    tiles = mode == "banded_tiles"
    if tiles:
        monkeypatch.setattr(tlim, "SEGMENT_MODEL", None)
        mode = "banded"
    prob = _grid(8, 12)
    assert prob.con_num == 1342
    j, t = _both(prob, normal_solver=mode, switch_admm=25, check_every=10)
    neq = t.params.neq
    assert neq.mode == j.params.neq.mode == mode
    if mode == "packed":
        assert neq.factor.layout[2:4] == (256, 6)
    elif tiles:
        assert isinstance(neq.factor, tchol.BandFactor) and neq.factor.form == "chain"
        assert neq.factor.layout[2:5] == (512, 3, 1) and neq.factor.perm is not None
        assert t.init_breakdown["neq.band_bw"] == 4
    else:
        seg = neq.factor.segments
        assert isinstance(neq.factor, tchol.SegmentFactor)
        assert (seg.n_segments, seg.max_seg) == (441, 18) and sorted(seg.order[seg.order >= 0]) == list(range(1342))
        assert t.init_breakdown["neq.band_bw"] == 4
    rj = j.solve(max_iter=50, stop_tol=0.0)
    rt = t.solve(max_iter=50, stop_tol=0.0)
    assert rj.iterations == rt.iterations == 50
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)


def test_auto_past_the_ceiling_raises_cg_on_the_cpu():
    """auto past dense_chol_max resolves to cg on the CPU, as the JAX
    package does there; both run 20 iterations of the 8x12 grid (1,342
    constraints) to the same info rows (rtol 1e-6: both CGs stop at
    64 eps64, the port's FSAI tables are the JAX package's)."""
    j, t = _both(_grid(8, 12), normal_solver="auto", dense_chol_max=1000, switch_admm=10, check_every=10)
    neq = t.params.neq
    assert neq.mode == j.params.neq.mode == "cg" and neq.factor.fsai_g is not None
    assert t.init_breakdown["neq.fsai_nnz"] > 1342
    rj = j.solve(max_iter=20, stop_tol=0.0)
    rt = t.solve(max_iter=20, stop_tol=0.0)
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)


def test_banded_level1_recovery_adds_two_sweeps():
    """Level-1 recovery adds two refinement sweeps in banded mode too (the
    JAX package's driver.py:356 skips banded; that defect is not copied).
    Poisoned factor (its band tiles, or its segments' band rows); one
    iteration, so only level 1 runs."""
    cfg = cuadmm_tpu_torch.SolverConfig(
        verbose=False, check_every=10, normal_solver="banded", switch_admm=10**9
    )
    s = cuadmm_tpu_torch.SDPSolver(_grid(), cfg, device="cpu")
    neq = s.params.neq
    assert neq.mode == "banded"
    f = neq.factor
    if isinstance(f, tchol.SegmentFactor):
        poisoned = dataclasses.replace(f, segments=f.segments._replace(band=torch.full_like(f.segments.band, float("nan"))))
    else:
        poisoned = dataclasses.replace(f, tiles=torch.full_like(f.tiles, float("nan")))
    bad = dataclasses.replace(neq, factor=poisoned)
    s.params = dataclasses.replace(s.params, neq=bad)
    res = s.solve(max_iter=1, stop_tol=1e-6)
    assert res.recoveries == 1
    assert s.params.neq.mode == "banded" and s.params.neq.applies == neq.applies + 2


def _quasar(n_poses: int = 3, seed: int = 0):
    """QUASAR (tests/test_torch_chol.py::_quasar): b = (N+1) e_0, a seeded
    symmetric C."""
    from cuadmm_tpu.models.quasar import quasar_constraints

    rows, cols, vals, con_num, n = quasar_constraints(n_poses)
    m = np.random.default_rng(seed).standard_normal((n, n))
    r, c = np.tril_indices(n)
    return cuadmm_tpu.Problem(
        blk=[("s", n)], con_num=con_num, At_rows=rows, At_cols=cols, At_vals=vals,
        b_indices=np.array([0]), b_vals=np.array([n_poses + 1.0]),
        C_indices=np.arange(len(r)), C_vals=((m + m.T) / 2)[r, c] * np.where(r == c, 1.0, np.sqrt(2.0)),
    )


def _maxcut():
    from cuadmm_tpu.models.maxcut import maxcut_sdp, random_graph

    return maxcut_sdp(random_graph(40, p=0.15, seed=2))


@pytest.mark.parametrize("make,p", [(_certified, 12), (_quasar, 31), (_maxcut, 0)], ids=["certified", "quasar", "maxcut"])
def test_split_slice_matches_jax(make, p):
    """The slice through split: normal_solver "auto" resolves to split in
    both packages (the JAX package's prefix is an f64 factor on the CPU, the
    port's an f32 inverse through K1's plain version, 4 sweeps each); 200
    iterations, the switch to ADMM at 100, info rows within rtol 1e-6."""
    j, t = _both(make(), normal_solver="auto", switch_admm=100, check_every=50)
    neq = t.params.neq
    assert neq.mode == j.params.neq.mode == "split" and neq.factor.p == p and neq.factor.perm is None
    assert (neq.factor.prefix is None) == (p == 0)
    rj = j.solve(max_iter=200, stop_tol=0.0)
    rt = t.solve(max_iter=200, stop_tol=0.0)
    assert rj.iterations == rt.iterations == 200
    for f in FIELDS:
        np.testing.assert_allclose(rt.info[f], rj.info[f], rtol=1e-6, atol=0, err_msg=f)


@pytest.mark.parametrize("mode", ["auto", "dense", "cg", "host"])
def test_certified_converges_through_each_normal_solver(mode):
    """The certified SDP to 1e-6 through each mode (auto is split): the
    same iteration count as the JAX package and its known optimum."""
    prob, _, _, _, opt = random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    j, t = _both(prob, normal_solver=mode, check_every=25, switch_admm=10**9)
    assert t.params.neq.mode == j.params.neq.mode == ("split" if mode == "auto" else mode)
    rj = j.solve(max_iter=6000, stop_tol=1e-6)
    rt = t.solve(max_iter=6000, stop_tol=1e-6)
    assert rt.converged and rj.converged and rt.iterations == rj.iterations
    assert abs(rt.pobj - opt) / (1 + abs(opt)) < 1e-4
