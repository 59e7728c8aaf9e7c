"""The port's host modules (numpy copies) against cuadmm_tpu's originals.

The port carries its own copies of the numpy-only host modules because
any import of cuadmm_tpu imports jax. Same inputs must give identical
arrays on both sides.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

pytest.importorskip("jax")

from cuadmm_tpu.models import chordal as jchordal
from cuadmm_tpu.models import maxcut as jmaxcut
from cuadmm_tpu.models import quasar as jquasar
from cuadmm_tpu.models import random_sdp as jrandom
from cuadmm_tpu.ops import sparse as jsparse
from cuadmm_tpu.solver import scaling as jscaling
from cuadmm_tpu.structure import BlockStructure as JBlockStructure

from cuadmm_tpu_torch.models import chordal as tchordal
from cuadmm_tpu_torch.models import maxcut as tmaxcut
from cuadmm_tpu_torch.models import quasar as tquasar
from cuadmm_tpu_torch.models import random_sdp as trandom
from cuadmm_tpu_torch.ops import sparse as tsparse
from cuadmm_tpu_torch.problem import Problem as TProblem
from cuadmm_tpu_torch.solver import scaling as tscaling
from cuadmm_tpu_torch.structure import BlockStructure as TBlockStructure

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

# 1x1, free, pow2-padded and (with pack_to) packed buckets.
MIXED_BLK = [("s", 1), ("s", 3), ("u", 4), ("s", 5), ("s", 1), ("s", 2), ("s", 7), ("s", 3)]


def band_graph(n, offsets):
    W = sp.diags([np.ones(n - k) for k in offsets], list(offsets), shape=(n, n))
    return W + W.T


def _assert_problems_equal(p, q):
    assert p.blk == q.blk and p.con_num == q.con_num and p.vec_len == q.vec_len
    for f in ("At_rows", "At_cols", "At_vals"):
        np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
    np.testing.assert_array_equal(p.dense_b(), q.dense_b())
    np.testing.assert_array_equal(p.dense_C(), q.dense_C())


def test_maxcut_chordal_identical():
    W = band_graph(40, (1, 2, 3))
    pj, info_j = jchordal.maxcut_chordal(W)
    pt, info_t = tchordal.maxcut_chordal(W)
    _assert_problems_equal(pj, pt)
    x = np.random.default_rng(0).standard_normal(pj.vec_len)
    assert (jchordal.extract_entries(info_j, x) != tchordal.extract_entries(info_t, x)).nnz == 0


@pytest.mark.parametrize("n_poses", [1, 3, 20])
def test_quasar_constraints_identical(n_poses):
    out_j = jquasar.quasar_constraints(n_poses)
    out_t = tquasar.quasar_constraints(n_poses)
    for a, b in zip(out_j[:3], out_t[:3]):
        np.testing.assert_array_equal(a, b)
    assert out_j[3:] == out_t[3:] == (1 + 10 * n_poses + 3 * n_poses * (n_poses + 1), 4 * (n_poses + 1))


def test_load_quasar_txt_identical(tmp_path):
    """blk, b and C from a TXT directory without At.txt; the constraints are
    regenerated (cuadmm_tpu/models/quasar.py:133)."""
    from cuadmm_tpu_torch.io import txt

    n = 16
    txt.write_blk(str(tmp_path / "blk.txt"), [("s", n)])
    txt.write_sparse_vector(str(tmp_path / "b.txt"), np.array([0]), np.array([4.0]))
    rng = np.random.default_rng(5)
    idx = np.sort(rng.choice(n * (n + 1) // 2, 40, replace=False))
    txt.write_sparse_vector(str(tmp_path / "C.txt"), idx, rng.standard_normal(40))
    _assert_problems_equal(jquasar.load_quasar_txt(str(tmp_path)), tquasar.load_quasar_txt(str(tmp_path)))


def test_maxcut_identical():
    W_j = jmaxcut.random_graph(40, p=0.1, seed=3)
    W_t = tmaxcut.random_graph(40, p=0.1, seed=3)
    np.testing.assert_array_equal(W_j, W_t)
    np.testing.assert_array_equal(
        jmaxcut.random_graph(12, p=0.5, weighted=True, seed=1), tmaxcut.random_graph(12, p=0.5, weighted=True, seed=1)
    )
    _assert_problems_equal(jmaxcut.maxcut_sdp(W_j), tmaxcut.maxcut_sdp(W_t))
    x = np.random.default_rng(2).standard_normal(40 * 41 // 2)
    signs = np.sign(np.random.default_rng(4).standard_normal(40))
    assert jmaxcut.cut_value(W_j, signs) == tmaxcut.cut_value(W_t, signs)
    assert jmaxcut.round_solution(W_j, x, trials=4) == tmaxcut.round_solution(W_t, x, trials=4)


def test_random_certified_identical():
    blk = [("s", 5), ("u", 3), ("s", 4)]
    pj, *rest_j = jrandom.random_certified_sdp(blk, con_num=10, seed=7)
    pt, *rest_t = trandom.random_certified_sdp(blk, con_num=10, seed=7)
    _assert_problems_equal(pj, pt)
    for a, b in zip(rest_j, rest_t):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rounding,pack_to", [("pow2", 0), ("exact", 0), ("pow2", 8)])
def test_block_structure_identical(rounding, pack_to):
    j = JBlockStructure(MIXED_BLK, rounding, 64, pack_to)
    t = TBlockStructure(MIXED_BLK, rounding, 64, pack_to)
    assert len(j.buckets) == len(t.buckets)
    if pack_to:
        assert any(bk.packed for bk in t.buckets)
    assert any(bk.n == 1 for bk in t.buckets) and len(t.free_pos) == 4
    for bj, bt in zip(j.buckets, t.buckets):
        assert (bj.n, bj.count, bj.n_groups, bj.packed) == (bt.n, bt.count, bt.n_groups, bt.packed)
        for f in ("sizes", "gather_idx", "gather_scale", "pool_pos", "out_scale", "svec_pos", "diag_blkid"):
            np.testing.assert_array_equal(getattr(bj, f), getattr(bt, f))
    for f in ("free_pos", "inv_perm", "bucket_base", "svec_pool_lo", "svec_pool_hi", "svec_offdiag"):
        np.testing.assert_array_equal(getattr(j, f), getattr(t, f))
    assert (j.vec_len, j.pool_len, j.free_base) == (t.vec_len, t.pool_len, t.free_base)


def test_scale_problem_identical():
    rng = np.random.default_rng(1)
    con, vec = 9, 21
    normA = np.maximum(1.0, rng.random(con) * 3)
    args = (normA, rng.standard_normal(con), rng.standard_normal(vec),
            rng.standard_normal(vec), rng.standard_normal(con), rng.standard_normal(vec))
    out_j = jscaling.scale_problem(*args)
    out_t = tscaling.scale_problem(*args)
    for f in ("normA", "bscale", "Cscale", "objscale", "norm_borg", "norm_Corg"):
        np.testing.assert_array_equal(getattr(out_j[0], f), getattr(out_t[0], f))
    for a, b in zip(out_j[1:], out_t[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("skewed", [False, True])
def test_build_ell_host_identical(skewed):
    rng = np.random.default_rng(17)
    out_len, in_len = 700, 900
    if skewed:  # a 1000-entry row next to singletons, and empty rows
        rows = np.concatenate([np.full(1000, 3), rng.integers(0, out_len, 800)])
    else:
        rows = rng.integers(0, out_len, 3000)
    cols = rng.integers(0, in_len, len(rows))
    vals = rng.standard_normal(len(rows))
    hj = jsparse._build_ell_host(rows, cols, vals, out_len, in_len)
    ht = tsparse._build_ell_host(rows, cols, vals, out_len, in_len)
    assert hj.keys() == ht.keys()
    for k in hj:
        a, b = hj[k], ht[k]
        if isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_txt_round_trip(tmp_path):
    pt, *_ = trandom.random_certified_sdp([("s", 4), ("u", 2)], con_num=6, seed=2)
    pt.to_txt(str(tmp_path / "p"))
    from cuadmm_tpu.problem import Problem as JProblem

    _assert_problems_equal(JProblem.from_txt(str(tmp_path / "p")), TProblem.from_txt(str(tmp_path / "p")))


def test_import_leaves_no_jax():
    code = (
        "import sys, cuadmm_tpu_torch, cuadmm_tpu_torch.convert, cuadmm_tpu_torch.models.chordal, "
        "cuadmm_tpu_torch.models.quasar, cuadmm_tpu_torch.models.maxcut, cuadmm_tpu_torch.ops.fsai; "
        "bad = [k for k in sys.modules if k in ('jax', 'cuadmm_tpu') "
        "or k.startswith(('jax.', 'cuadmm_tpu.'))]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=REPO)
