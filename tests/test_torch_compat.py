"""The port's ``cuadmm`` wrapper, checkpoints and examples against
cuadmm_tpu's.

``cuadmm`` takes the same inputs in both packages with ``normal_solver``
and ``projection`` pinned ("dense", "eigh": an f64 Cholesky and eigh in
both): X/y/S within 1e-9 (relative to the largest entry), the ten info
rows of equal length within rtol 1e-8; the residual rows (errRp, errRd,
relgap, themselves relative) also within an absolute 1e-13, since a
converged primal residual sits at f64 rounding (1e-16-1e-15) where the two
packages' sums differ in every digit. A checkpoint written by either
package resumes in the other within 60 iterations (tests/test_compat.py:48)
with equal iteration counts.
"""

import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

import cuadmm_tpu
from cuadmm_tpu.compat import cuadmm as jcuadmm
from cuadmm_tpu.utils import checkpoint as jck

import chip_smoke as cs
import cuadmm_tpu_torch
from cuadmm_tpu_torch.compat import cuadmm as tcuadmm
from cuadmm_tpu_torch.examples import maxcut_demo, minimizer, mosek_pipeline
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(1)

ITER_ROWS = ("pobj_arr", "dobj_arr", "errRp_arr", "errRd_arr", "relgap_arr", "sig_arr", "bscale_arr", "Cscale_arr")
PIN = dict(verbose=False, normal_solver="dense", projection="eigh")
RESUME_MAX_ITERS = 60
SOL_TOL = 1e-9
RESIDUAL_ROWS = ("errRp_arr", "errRd_arr", "relgap_arr")
ROUNDING_FLOOR = 1e-13


def _inputs(prob):
    At = sp.coo_matrix((prob.At_vals, (prob.At_rows, prob.At_cols)), shape=(prob.vec_len, prob.con_num))
    return At, prob.dense_b(), prob.dense_C(), [n for _, n in prob.blk]


def _close(a, b, tol=SOL_TOL):
    return float(np.max(np.abs(a - b))) <= tol * (1 + float(np.max(np.abs(b))))


CASES = {
    # tests/test_compat.py's instance, and the certified SDP with an LP part
    # (chip_smoke.certified_lp_free; ``blk_vec`` holds PSD sizes only).
    "compat": lambda: random_certified_sdp([("s", 5), ("s", 3)], con_num=8, seed=2),
    "lp": lambda: cs.certified_lp_free("sdpa"),
}


@pytest.mark.parametrize("case,switch_admm", [("compat", 10**9), ("lp", 10**9), ("compat", 100)],
                         ids=["compat-sgs", "lp-sgs", "compat-admm-switch"])
def test_cuadmm_matches_jax(case, switch_admm):
    prob, *_, opt = CASES[case]()
    args = (15, 5000, 1e-6, *_inputs(prob))
    kw = dict(PIN, sig=1.0, switch_admm=switch_admm)
    Xj, yj, Sj, ij = jcuadmm(*args, **kw)
    Xt, yt, St, it = tcuadmm(*args, device="cpu", **kw)
    assert isinstance(Xt, np.ndarray) and isinstance(yt, np.ndarray) and isinstance(St, np.ndarray)
    for a, b in ((Xt, Xj), (yt, yj), (St, Sj)):
        assert a.shape == b.shape and _close(a, b)
    assert sorted(it) == sorted(ij) and len(it) == 10
    assert it["iter_num"] == ij["iter_num"] > 0
    for r in ITER_ROWS:
        assert len(it[r]) == len(ij[r]) == it["iter_num"], r
        atol = ROUNDING_FLOOR if r in RESIDUAL_ROWS else 0.0
        np.testing.assert_allclose(it[r], ij[r], rtol=1e-8, atol=atol, err_msg=r)
    assert abs(it["pobj_arr"][-1] - opt) / (1 + abs(opt)) < 1e-4


def test_cuadmm_warm_start_args_match_jax():
    """X0/y0/S0/sig go through unscaled, as the MEX's X_new/y_new/S_new/sig_new."""
    prob, *_ = CASES["compat"]()
    rng = np.random.default_rng(5)
    warm = dict(X0=rng.standard_normal(prob.vec_len), y0=rng.standard_normal(prob.con_num),
                S0=rng.standard_normal(prob.vec_len), sig=3.0)
    args = (0, 40, 0.0, *_inputs(prob))
    Xj, _, _, ij = jcuadmm(*args, **warm, **PIN)
    Xt, _, _, it = tcuadmm(*args, **warm, device="cpu", **PIN)
    assert it["iter_num"] == ij["iter_num"] == 40 and _close(Xt, Xj)
    np.testing.assert_allclose(it["sig_arr"], ij["sig_arr"], rtol=1e-8, atol=0)


def _solver(pkg, prob):
    cfg = dict(PIN, switch_admm=10**9)
    if pkg == "jax":
        return cuadmm_tpu.SDPSolver(prob, cuadmm_tpu.SolverConfig(**cfg))
    return cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(**cfg), device="cpu")


@pytest.mark.parametrize("first_tol", [1e-6, 1e-4])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_resumes_in_both_packages(tmp_path, writer, first_tol):
    """A run to ``first_tol`` checkpointed by ``writer``'s save_checkpoint
    resumes to 1e-6 in both packages with equal iteration counts: within
    RESUME_MAX_ITERS from a converged checkpoint, and from a 1e-4 one
    within RESUME_MAX_ITERS of what an uninterrupted run takes past it."""
    prob, *_ = CASES["compat"]()
    res = _solver(writer, prob).solve(max_iter=5000, stop_tol=first_tol)
    assert res.converged
    path = str(tmp_path / "ck.npz")
    (jck if writer == "jax" else tck).save_checkpoint(path, res)
    its = {}
    for reader, mod in (("jax", jck), ("torch", tck)):
        ck = mod.load_checkpoint(path)
        assert sorted(ck) == ["S0", "X0", "sig", "y0"]
        r = _solver(reader, prob).solve(max_iter=5000, stop_tol=1e-6, **ck)
        assert r.converged
        its[reader] = r.iterations
    rest = _solver(writer, prob).solve(max_iter=5000, stop_tol=1e-6).iterations - res.iterations
    assert its["jax"] == its["torch"] and abs(its["torch"] - rest) <= RESUME_MAX_ITERS


def test_checkpoint_file_format_matches_jax(tmp_path):
    """Keys X, y, S, sig with the same dtypes and values from both writers;
    tensors (on any device) are copied to the host."""
    rng = np.random.default_rng(1)
    arrays = dict(X=rng.standard_normal(6), y=rng.standard_normal(3), S=rng.standard_normal(6))
    res = types.SimpleNamespace(**arrays, sig=2.5)
    as_tensors = types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                                       sig=torch.tensor(2.5, dtype=torch.float64))
    paths = {name: str(tmp_path / f"{name}.npz") for name in ("jax", "torch", "tensors")}
    jck.save_checkpoint(paths["jax"], res)
    tck.save_checkpoint(paths["torch"], res)
    tck.save_checkpoint(paths["tensors"], as_tensors)
    tck.save_checkpoint(str(tmp_path / "sig.npz"), res, sig=7.0)
    assert jck.load_checkpoint(str(tmp_path / "sig.npz"))["sig"] == 7.0
    loaded = {name: np.load(p) for name, p in paths.items()}
    for name, z in loaded.items():
        assert sorted(z.files) == ["S", "X", "sig", "y"], name
        for k in z.files:
            ref = loaded["jax"][k]
            assert z[k].dtype == ref.dtype and z[k].shape == ref.shape and np.array_equal(z[k], ref), (name, k)


def test_example_minimizer_on_cpu(capsys):
    minimizer.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "min eigenvalue" in out and "iterations:" in out
    lam = float(out.split("min eigenvalue:")[1].split()[0])
    assert lam > -1e-3


def test_example_maxcut_demo_on_cpu(capsys):
    maxcut_demo.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "dense:   Solver ended: converged" in out and "chordal: Solver ended: converged" in out


def test_example_mosek_pipeline(tmp_path, capsys):
    """On a MOSEK file written by chip_smoke.write_mosek (the certified SDP
    with its free part); with no path it exits 2 and says it needs one."""
    prob = cs.certified_lp_free("mosek")[0]
    path = cs.write_file(prob, "mosek", tmp_path / "cert")
    mosek_pipeline.main([str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"{prob.con_num} constraints" in out and "pobj" in out
    with pytest.raises(SystemExit) as exc:
        mosek_pipeline.main([])
    assert exc.value.code == 2 and "needs the path" in capsys.readouterr().err
