"""The generators give the published sizes, the chordal copy gives the
program's generator's arrays exactly, and QUASAR's C is the paper's
truncated-least-squares cost of the seed's measurements."""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench.generators import quasar, toroidal_maxcut  # noqa: E402

G11 = {"rows": 100, "cols": 8}
QUASAR = json.loads((REPO / "portbench" / "configs" / "quasar500.json").read_text())["generator_params"]
FIELDS = ("At_rows", "At_cols", "At_vals", "b_indices", "b_vals", "C_indices", "C_vals")


def test_the_toroidal_grid_is_rudys():
    W = toroidal_maxcut.toroidal_grid(100, 8)
    assert W.shape == (800, 800) and W.nnz == 2 * 1600 and (W != W.T).nnz == 0
    assert set(np.asarray(W.sum(axis=1)).ravel()) == {4.0} and set(W.data) == {1.0}
    assert W[0, 1] == W[0, 7] == W[0, 8] == W[0, 792] == 1.0  # right and lower neighbours, wrapped
    with pytest.raises(ValueError):
        toroidal_maxcut.toroidal_grid(100, 2)


def test_gset_g11_sizes_and_the_seed_changes_nothing():
    a = toroidal_maxcut.generate(G11, 2**31 + 3)
    b = toroidal_maxcut.generate(G11, 7)
    assert a.con_num == 18_692 and a.vec_len == 26_225 and len(a.At_vals) == 36_584
    sizes = sorted({n for _, n in a.blk})
    assert sizes == [5, 9, 13, 18, 24] and len(a.blk) == 598
    assert a.blk == b.blk
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("config", ["gset_g11_chordal", "quasar500"])
def test_each_configuration_file_states_the_sizes_its_generator_gives(config):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{config}.json").read_text())
    prob = importlib.import_module(f"portbench.generators.{cfg['generator']}").generate(cfg["generator_params"], 1)
    sizes = cfg["sizes"]
    assert (prob.con_num, prob.vec_len, len(prob.At_vals)) == (sizes["con_num"], sizes["vec_len"], sizes["at_nnz"])
    counts = {}
    for kind, n in prob.blk:
        assert kind == "s"
        counts[str(n)] = counts.get(str(n), 0) + 1
    assert counts == sizes["psd_blocks"]


def test_quasar500_sizes():
    q = quasar.generate(QUASAR, 2**31 + 3)
    assert q.con_num == 756_501 and len(q.At_vals) == 1_515_004 and q.blk == [("s", 2004)]
    assert q.b_indices.tolist() == [0] and q.b_vals.tolist() == [501.0]
    # The block arrow: 500 diagonal blocks (10 entries each) and 500 blocks
    # of the first four rows (16 each), no more.
    assert q.vec_len == 2004 * 2005 // 2 and len(q.C_vals) == 500 * 26


@pytest.mark.parametrize("rows, cols", [(5, 4), (12, 6)])
def test_the_chordal_copy_gives_the_programs_arrays(rows, cols):
    from cuadmm_tpu_torch.models.chordal import maxcut_chordal

    got = toroidal_maxcut.generate(dict(rows=rows, cols=cols), 0)
    want, _ = maxcut_chordal(toroidal_maxcut.toroidal_grid(rows, cols))
    assert got.blk == want.blk and got.con_num == want.con_num
    for f in FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f


def test_the_quasar_copy_gives_the_programs_constraints():
    from cuadmm_tpu_torch.models.quasar import quasar_constraints

    got = quasar.quasar_constraints(12)
    want = quasar_constraints(12)
    assert got[3:] == want[3:] and all(np.array_equal(g, w) for g, w in zip(got[:3], want[:3]))


@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_quasar_residual_forms_and_rotation(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((6, 3)), rng.standard_normal((6, 3))
    M = quasar.residual_forms(a, b)
    for _ in range(4):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = quasar.rotation(q)
        assert np.allclose(R @ R.T, np.eye(3)) and np.isclose(np.linalg.det(R), 1.0)
        np.testing.assert_allclose(np.einsum("i,nij,j->n", q, M, q), np.sum((b - a @ R.T) ** 2, axis=1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_quasar_cost_is_the_truncated_least_squares_cost(seed):
    params = dict(QUASAR, n_poses=9)
    a, b, q = quasar.measurements(params, seed)
    beta, cbar2 = params["noise_bound"], params["cbar2"]
    C = quasar.cost_matrix(a, b, beta, cbar2)
    assert np.array_equal(C, C.T) and not C[:4, :4].any()
    r = np.sum((b - a @ quasar.rotation(q).T) ** 2, axis=1)
    assert np.sum(r > 10 * beta**2) >= 3  # the outliers are there
    for t in np.random.default_rng(seed).choice([-1.0, 1.0], (5, 9)):
        x = np.concatenate([q, (t[:, None] * q[None]).ravel()])
        tls = np.sum((1 + t) / 2 * r / beta**2 + (1 - t) / 2 * cbar2)
        assert x @ C @ x == pytest.approx(tls, rel=1e-12)
    # The svec of C: the lower triangle, off-diagonals times sqrt(2).
    prob = quasar.generate(params, seed)
    dense = np.zeros(prob.vec_len)
    dense[prob.C_indices] = prob.C_vals
    rr, cc = np.tril_indices(40)
    np.testing.assert_allclose(dense, C[rr, cc] * np.where(rr == cc, 1.0, np.sqrt(2.0)), rtol=1e-15)
