"""The whole port slice against cuadmm_tpu's SDPSolver (f64, precond/eigh).

Both solvers run the same problem with ``normal_solver="precond"``,
``projection="eigh"`` and ``precond_applies=4`` pinned. Info rows agree to
rtol 1e-6: the port's normal solve applies an f32 inverse factor with f64
refinement where the JAX package on the CPU uses an f64 cho_solve, and
300 iterations carry the difference along.
"""

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


def _both(prob, **cfg):
    kw = dict(verbose=False, normal_solver="precond", projection="eigh", precond_applies=4, **cfg)
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
    with pytest.raises(NotImplementedError, match="poly"):
        cuadmm_tpu_torch.SDPSolver(
            prob, cuadmm_tpu_torch.SolverConfig(projection="poly", normal_solver="precond"), device="cpu"
        )


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
    import dataclasses

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
