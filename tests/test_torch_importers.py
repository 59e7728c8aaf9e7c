"""The port's importers (SDPA, SeDuMi, MOSEK, cuADMM .mat, TXT) against
cuadmm_tpu's, on files written by chip_smoke.py's writers.

Each file is written from a Problem made by an in-repo generator (nothing
is read from outside the repository), loaded through the JAX loader and
the port's loader, and every field must be ``np.array_equal`` between the
two; against the generator's Problem, exactly for .mat files and within
1e-15 relative for text (TXT writes 16 digits, SDPA divides off-diagonal
entries by sqrt(2)). Bad files must raise the same exception, with the
same message, in both packages.
"""

import gzip

import numpy as np
import pytest
import scipy.io as sio
import scipy.sparse as sp

pytest.importorskip("jax")

from cuadmm_tpu.io import admm_mat as jadmm
from cuadmm_tpu.io import mosek as jmosek
from cuadmm_tpu.io import sdpa as jsdpa
from cuadmm_tpu.io import sedumi as jsedumi
from cuadmm_tpu.problem import Problem as JProblem

import chip_smoke as cs
from cuadmm_tpu_torch.io import admm_mat as tadmm
from cuadmm_tpu_torch.io import mosek as tmosek
from cuadmm_tpu_torch.io import sdpa as tsdpa
from cuadmm_tpu_torch.io import sedumi as tsedumi
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.problem import Problem as TProblem

FIELDS = ("blk", "con_num", "At_rows", "At_cols", "At_vals", "b_indices", "b_vals",
          "C_indices", "C_vals", "X0", "y0", "S0", "sig0", "name")
TEXT_REL_TOL = 1e-15


def _grid_maxcut(rows=4, cols=6):
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    return maxcut_chordal((W + W.T).tocsr())[0]


PROBLEMS = {
    # The certified SDP with an LP part and a free part, in each importer's
    # block order (chip_smoke.certified_lp_free), and a chordal max-cut.
    "certified_sedumi_order": lambda: cs.certified_lp_free("sedumi")[0],
    "certified_mosek_order": lambda: cs.certified_lp_free("mosek")[0],
    "certified_lp_only": lambda: cs.certified_lp_free("sdpa")[0],
    "grid_maxcut": _grid_maxcut,
}
CASES = [
    (name, fmt)
    for name, fmts in (
        ("certified_sedumi_order", ("txt", "sedumi", "admm_mat")),
        ("certified_mosek_order", ("txt", "mosek", "admm_mat")),
        ("certified_lp_only", tuple(cs.FORMATS)),
        ("grid_maxcut", tuple(cs.FORMATS)),
    )
    for fmt in fmts
]


def _load(pkg, fmt, path, blk):
    if fmt == "txt":
        return (JProblem if pkg == "jax" else TProblem).from_txt(str(path))
    if fmt.startswith("sdpa"):
        return (jsdpa if pkg == "jax" else tsdpa).load_sdpa(str(path))
    if fmt == "sedumi":
        return (jsedumi if pkg == "jax" else tsedumi).load_sedumi_mat(str(path))
    if fmt == "mosek":
        return (jmosek if pkg == "jax" else tmosek).load_mosek_mat(str(path))
    return (jadmm if pkg == "jax" else tadmm).load_admm_mat(str(path), blk=blk)


def _assert_same(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f
        else:
            assert a == b, f


@pytest.mark.parametrize("name,fmt", CASES, ids=[f"{n}-{f}" for n, f in CASES])
def test_importer_matches_jax_and_generator(tmp_path, name, fmt):
    prob = PROBLEMS[name]()
    if fmt in ("sedumi", "mosek", "sdpa"):
        assert cs._fits(fmt, prob.blk)
    path = cs.write_file(prob, fmt, tmp_path / name)
    t = _load("torch", fmt, path, prob.blk)
    j = _load("jax", fmt, path, prob.blk)
    _assert_same(t, j)
    text = cs.FORMATS[fmt][1]
    assert cs.problem_mismatch(t, prob, TEXT_REL_TOL if text else 0.0) == []
    if fmt == "sdpa_gz":
        with gzip.open(path, "rt") as f:
            assert f.readline().strip() == str(prob.con_num)


def test_lp_block_and_free_block_layout(tmp_path):
    """SDPA's LP run is one negative-size block; SeDuMi's K.f/K.l and MOSEK's
    free scalars come back as one 'u' block and 1x1 's' blocks."""
    lp = cs.certified_lp_free("sdpa")[0]
    path = cs.write_file(lp, "sdpa", tmp_path / "lp")
    sizes = path.read_text().splitlines()[2].split()
    assert sizes == ["6", "4", f"-{cs.CERT_LP}"]
    p = tsdpa.load_sdpa(str(path))
    assert p.blk == [("s", 6), ("s", 4)] + [("s", 1)] * cs.CERT_LP

    sed = cs.certified_lp_free("sedumi")[0]
    path = cs.write_file(sed, "sedumi", tmp_path / "sed")
    K = sio.loadmat(str(path), squeeze_me=True, struct_as_record=False)["K"]
    assert (int(K.f), int(K.l), list(np.atleast_1d(K.s).astype(int))) == (cs.CERT_FREE, cs.CERT_LP, [6, 4])
    assert tsedumi.load_sedumi_mat(str(path)).blk[0] == ("u", cs.CERT_FREE)

    mos = cs.certified_lp_free("mosek")[0]
    path = cs.write_file(mos, "mosek", tmp_path / "mos")
    assert tmosek.load_mosek_mat(str(path)).blk[-1] == ("u", cs.CERT_FREE)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sedumi_detects_at_in_place_of_a(tmp_path, pkg):
    """sedumi_to_problem transposes an At passed as A (sedumi.py:67-69), and
    load_sedumi_mat reads a file that stores At."""
    mod = jsedumi if pkg == "jax" else tsedumi
    prob = cs.certified_lp_free("sedumi")[0]
    path = cs.write_file(prob, "sedumi", tmp_path / "p")
    m = sio.loadmat(str(path), squeeze_me=True, struct_as_record=False)
    ref = mod.sedumi_to_problem(m["A"], m["b"], m["c"], m["K"])
    _assert_same(mod.sedumi_to_problem(m["A"].T, m["b"], m["c"], m["K"]), ref)
    at_path = tmp_path / "at.mat"
    sio.savemat(str(at_path), {"At": m["A"].T, "b": m["b"], "c": m["c"], "K": {"f": 3.0, "l": 20.0, "s": [6.0, 4.0]}})
    got = mod.load_sedumi_mat(str(at_path), name="sedumi")
    _assert_same(got, ref)


def test_admm_mat_infers_single_block(tmp_path):
    prob = random_certified_sdp([("s", 7)], con_num=9, seed=4)[0]
    path = cs.write_file(prob, "admm_mat", tmp_path / "one")
    t, j = tadmm.load_admm_mat(str(path)), jadmm.load_admm_mat(str(path))
    _assert_same(t, j)
    assert t.blk == [("s", 7)] and cs.problem_mismatch(t, prob) == []


def _bad_files(tmp_path):
    """(name, callable(package modules) -> raises) for each bad input."""
    A = sp.csc_matrix(np.ones((2, 4)))
    diag_sdpa = tmp_path / "diag.dat-s"
    diag_sdpa.write_text("1\n1\n-2\n1.0\n1 1 1 2 1.0\n")
    short_sdpa = tmp_path / "short.dat-s"
    short_sdpa.write_text("1\n1\n2\n1.0\n1 1 1 1\n")
    admm_bad_b = tmp_path / "admm_b.mat"
    sio.savemat(str(admm_bad_b), {"At": sp.csc_matrix(np.ones((3, 2))), "b": np.ones((3, 1)), "C": np.ones((3, 1))})
    admm_not_tri = tmp_path / "admm_tri.mat"
    sio.savemat(str(admm_not_tri), {"At": sp.csc_matrix(np.ones((4, 2))), "b": np.ones((2, 1)), "C": np.ones((4, 1))})
    no_a = tmp_path / "no_a.mat"
    sio.savemat(str(no_a), {"b": np.ones(2), "c": np.ones(4), "K": {"s": 2.0}})
    no_prob = tmp_path / "no_prob.mat"
    sio.savemat(str(no_prob), {"a": np.ones(2)})
    mosek_base = {"bardim": 2, "bara": {"subi": [1], "subj": [1], "subk": [1], "subl": [1], "val": [1.0]}}
    return {
        "sedumi_q_cone": lambda m: m["sedumi"].sedumi_to_problem(A, np.ones(2), np.ones(4), {"s": 2, "q": 3}),
        "sedumi_b_length": lambda m: m["sedumi"].sedumi_to_problem(A, np.ones(3), np.ones(4), {"s": 2}),
        "sedumi_columns": lambda m: m["sedumi"].sedumi_to_problem(A, np.ones(2), np.ones(4), {"s": 3}),
        "sedumi_no_a": lambda m: m["sedumi"].load_sedumi_mat(str(no_a)),
        "mosek_blc_ne_buc": lambda m: m["mosek"].mosek_to_problem(dict(mosek_base, blc=[1.0], buc=[2.0])),
        "mosek_bounded_scalar": lambda m: m["mosek"].mosek_to_problem(dict(
            mosek_base, blc=[1.0], buc=[1.0], a=np.ones((1, 1)), blx=[0.0], bux=[np.inf])),
        "mosek_no_prob": lambda m: m["mosek"].load_mosek_mat(str(no_prob)),
        "sdpa_offdiag_in_diag_block": lambda m: m["sdpa"].load_sdpa(str(diag_sdpa)),
        "sdpa_entry_count": lambda m: m["sdpa"].load_sdpa(str(short_sdpa)),
        "admm_b_length": lambda m: m["admm"].load_admm_mat(str(admm_bad_b)),
        "admm_vec_len_not_triangular": lambda m: m["admm"].load_admm_mat(str(admm_not_tri)),
    }


BAD = ["sedumi_q_cone", "sedumi_b_length", "sedumi_columns", "sedumi_no_a", "mosek_blc_ne_buc",
       "mosek_bounded_scalar", "mosek_no_prob", "sdpa_offdiag_in_diag_block", "sdpa_entry_count",
       "admm_b_length", "admm_vec_len_not_triangular"]


@pytest.mark.parametrize("case", BAD)
def test_bad_input_raises_as_in_jax(tmp_path, case):
    fn = _bad_files(tmp_path)[case]
    mods = {
        "jax": dict(sedumi=jsedumi, mosek=jmosek, sdpa=jsdpa, admm=jadmm),
        "torch": dict(sedumi=tsedumi, mosek=tmosek, sdpa=tsdpa, admm=tadmm),
    }
    raised = {}
    for pkg, m in mods.items():
        with pytest.raises(Exception) as exc:
            fn(m)
        raised[pkg] = (type(exc.value), str(exc.value))
    assert raised["torch"] == raised["jax"]
    assert raised["torch"][0] in (ValueError, NotImplementedError)
