"""The port's CLI (``python -m cuadmm_tpu_torch``) against cuadmm_tpu's.

One TXT directory through ``main`` of both packages (``--platform cpu``
and ``--device cpu``, ``--normal-solver dense`` so that both take an f64
Cholesky; "auto" projection reads the same CPU table in both): the same
exit code, the same iteration count, ``X_opt.txt`` within 1e-9 relative,
and identical ``info`` text. JAX is imported inside the tests that compare
with it, so the card-only test at the end runs with ``--noconftest`` on a
machine without jax.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cuadmm_tpu_torch
from cuadmm_tpu_torch.cli import main as tmain
from cuadmm_tpu_torch.io import txt as txtio
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.trace import COUNTS

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
X_REL_TOL = 1e-9


@pytest.fixture()
def prob_dir(tmp_path):
    """tests/test_cli.py's problem directory."""
    prob, *_ = random_certified_sdp([("s", 5), ("s", 3)], con_num=8, seed=1)
    d = tmp_path / "prob"
    prob.to_txt(str(d))
    return d


def _run_both(monkeypatch, prob_dir, args):
    """``main`` of each package on ``args`` (each writing its own X_opt):
    {package: (exit code, iterations, X)}."""
    jcli = pytest.importorskip("cuadmm_tpu.cli")
    import cuadmm_tpu

    out = {}
    for pkg, main, solver_cls, dev in (("jax", jcli.main, cuadmm_tpu.SDPSolver, ["--platform", "cpu"]),
                                       ("torch", tmain, cuadmm_tpu_torch.SDPSolver, ["--device", "cpu"])):
        seen = []
        orig = solver_cls.solve

        def recording(self, *a, _orig=orig, _seen=seen, **kw):
            res = _orig(self, *a, **kw)
            _seen.append(res.iterations)
            return res

        monkeypatch.setattr(solver_cls, "solve", recording)
        x_path = prob_dir / f"X_{pkg}.txt"
        rc = main(["solve", str(prob_dir), *args, *dev, "--output", str(x_path)])
        out[pkg] = (rc, seen, txtio.read_dense_vector(str(x_path)))
    return out


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def test_cli_solve_matches_jax(monkeypatch, prob_dir):
    args = ["--max-iter", "5000", "--stop-tol", "1e-5", "--switch-admm", "1000000000",
            "--normal-solver", "dense", "--quiet"]
    out = _run_both(monkeypatch, prob_dir, args)
    (rc_j, it_j, x_j), (rc_t, it_t, x_t) = out["jax"], out["torch"]
    assert rc_t == rc_j == 0
    assert it_t == it_j and len(it_t) == 1
    assert np.all(np.isfinite(x_t)) and _rel(x_t, x_j) <= X_REL_TOL


def test_cli_nonconverged_exit_code_matches_jax(monkeypatch, prob_dir):
    out = _run_both(monkeypatch, prob_dir, ["--max-iter", "3", "--stop-tol", "1e-12",
                                            "--normal-solver", "dense", "--quiet"])
    assert out["torch"][0] == out["jax"][0] == 2
    assert out["torch"][1] == out["jax"][1] == [3]
    assert _rel(out["torch"][2], out["jax"][2]) <= X_REL_TOL


def test_cli_warm_start_and_sgs_switch_match_jax(monkeypatch, prob_dir):
    """--warm-start reads X.txt/y.txt/S.txt; --switch-admm 40 switches to
    ADMM mid-run and returns the best iterate."""
    rng = np.random.default_rng(0)
    prob = cuadmm_tpu_torch.Problem.from_txt(str(prob_dir))
    txtio.write_dense_vector(str(prob_dir / "X.txt"), rng.standard_normal(prob.vec_len))
    txtio.write_dense_vector(str(prob_dir / "y.txt"), rng.standard_normal(prob.con_num))
    txtio.write_dense_vector(str(prob_dir / "S.txt"), rng.standard_normal(prob.vec_len))
    out = _run_both(monkeypatch, prob_dir, ["--max-iter", "400", "--stop-tol", "1e-6", "--switch-admm", "40",
                                            "--check-every", "20", "--normal-solver", "dense",
                                            "--warm-start", "--quiet"])
    assert out["torch"][:2] == out["jax"][:2]
    assert _rel(out["torch"][2], out["jax"][2]) <= X_REL_TOL


def test_cli_info_text_matches_jax(prob_dir, capsys):
    jcli = pytest.importorskip("cuadmm_tpu.cli")
    assert jcli.main(["info", str(prob_dir)]) == 0
    j = capsys.readouterr().out
    assert tmain(["info", str(prob_dir)]) == 0
    t = capsys.readouterr().out
    assert t == j and "constraints: 8" in t and "bucket" in t


def test_cli_flags_match_jax():
    """Every flag, choice and default of ``solve`` is the JAX CLI's, with
    --device (default cuda) in place of --platform."""
    import argparse

    jcli = pytest.importorskip("cuadmm_tpu.cli")

    def solve_actions(main):
        seen = {}

        class Stop(Exception):
            pass

        def grab(self, args=None, namespace=None):
            sub = next(a for a in self._actions if isinstance(a, argparse._SubParsersAction))
            seen.update({a.dest: (a.default, a.choices, a.type) for a in sub.choices["solve"]._actions})
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(Stop):
                main(["info", "x"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    j, t = solve_actions(jcli.main), solve_actions(tmain)
    assert t.pop("device")[0] == "cuda"
    assert j.pop("platform")[0] is None
    assert t == j
    assert t["switch_admm"][0] == 5000


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the error raised where no card is present")
def test_cli_device_cuda_raises_without_card(prob_dir):
    with pytest.raises(RuntimeError, match="cuda"):
        tmain(["solve", str(prob_dir), "--max-iter", "3", "--quiet"])


def test_python_m_runs_as_subprocess(prob_dir):
    """``python -m cuadmm_tpu_torch info`` prints what ``main`` prints, and
    ``solve --device cpu`` writes X_opt.txt and exits 0 when converged."""
    run = lambda *a: subprocess.run([sys.executable, "-m", "cuadmm_tpu_torch", *a], cwd=REPO,
                                    capture_output=True, text=True, timeout=300)
    info = run("info", str(prob_dir))
    assert info.returncode == 0 and "constraints: 8" in info.stdout, info.stderr
    solve = run("solve", str(prob_dir), "--device", "cpu", "--max-iter", "5000", "--stop-tol", "1e-5",
                "--switch-admm", "1000000000", "--quiet")
    assert solve.returncode == 0, solve.stderr
    x = txtio.read_dense_vector(str(prob_dir / "X_opt.txt"))
    assert x.shape == (cuadmm_tpu_torch.Problem.from_txt(str(prob_dir)).vec_len,) and np.all(np.isfinite(x))
    usage = run()
    assert usage.returncode == 2 and "usage" in usage.stderr


@pytest.mark.cuda
def test_cli_and_cuadmm_on_card(prob_dir):
    """On the card: the CLI subprocess converges and matches an in-process
    run to 1e-10; ``cuadmm`` with precond and jacobi launches K1 and K4 and
    agrees with its CPU run to 1e-6 (an f32 inverse factor on both
    devices, summed in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K4 have no CPU or interpret mode")
    import scipy.sparse as sp

    from cuadmm_tpu_torch.compat import cuadmm

    proc = subprocess.run([sys.executable, "-m", "cuadmm_tpu_torch", "solve", str(prob_dir), "--device", "cuda",
                           "--max-iter", "5000", "--stop-tol", "1e-5", "--switch-admm", "1000000000", "--quiet"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    x_cli = txtio.read_dense_vector(str(prob_dir / "X_opt.txt"))
    prob = cuadmm_tpu_torch.Problem.from_txt(str(prob_dir))
    cfg = cuadmm_tpu_torch.SolverConfig(max_iter=5000, stop_tol=1e-5, switch_admm=10**9, verbose=False)
    res = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cuda").solve()
    assert res.converged and _rel(x_cli, res.X) <= 1e-10

    At = sp.coo_matrix((prob.At_vals, (prob.At_rows, prob.At_cols)), shape=(prob.vec_len, prob.con_num))
    args = (0, 5000, 1e-6, At, prob.dense_b(), prob.dense_C(), [5, 3])
    kw = dict(sig=1.0, verbose=False, switch_admm=10**9, normal_solver="precond", projection="jacobi")
    before = COUNTS["k1"], COUNTS["k4"]
    X, y, S, info = cuadmm(*args, device="cuda", **kw)
    torch.cuda.synchronize()
    assert COUNTS["k1"] - before[0] >= info["iter_num"] > 0
    assert COUNTS["k4"] - before[1] >= 2 * info["iter_num"]  # the 5x5 and 3x3 buckets
    Xc, *_ = cuadmm(*args, device="cpu", **kw)
    assert np.all(np.isfinite(X)) and info["errRp_arr"][-1] < 1e-6
    assert _rel(X, Xc) <= 1e-6
