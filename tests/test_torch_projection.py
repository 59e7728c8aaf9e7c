"""PSD projection of the port against cuadmm_tpu.ops.projection (f64):
the eigh, jacobi and poly methods, a per-bucket dict, and packing, in pool
coordinates (psd_project_pool) and svec coordinates (psd_project), with
eigh_by_bucket overrides."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from cuadmm_tpu.ops import projection as jproj
from cuadmm_tpu.ops import svec as jsvec

from cuadmm_tpu_torch.ops import projection as tproj
from cuadmm_tpu_torch.ops import svec as tsvec
from cuadmm_tpu_torch.structure import BlockStructure

torch.set_num_threads(1)

CPU = torch.device("cpu")
# 1x1, free, pow2-padded and (with pack_to) packed buckets; blocks of very
# different norms share a packed super-matrix.
MIXED_BLK = [("s", 1), ("s", 3), ("u", 4), ("s", 5), ("s", 1), ("s", 2), ("s", 7), ("s", 3)]


@pytest.mark.parametrize(
    "pack_to,eig_rank", [(0, None), (8, None), (0, 2)], ids=["plain", "packed", "eig_rank"]
)
def test_psd_project_pool_matches_jax(pack_to, eig_rank):
    st = BlockStructure(MIXED_BLK, "pow2", 64, pack_to)
    assert any(bk.packed for bk in st.buckets) == bool(pack_to)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(st.vec_len) * 3
    x[:20] *= 1e-3
    jm = jsvec.device_maps(st, jnp.float64)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    pool = np.array(jsvec.pool_from_svec(jnp.asarray(x), jm))
    pj = np.asarray(jproj.psd_project_pool(jnp.asarray(pool), jm, eig_rank=eig_rank, method="eigh"))
    pt = tproj.psd_project_pool(torch.as_tensor(pool), tm, eig_rank=eig_rank).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10)


def _pools(blk, pack_to, seed=4):
    st = BlockStructure(blk, "pow2", 64, pack_to)
    x = np.random.default_rng(seed).standard_normal(st.vec_len) * 3
    x[:20] *= 1e-3
    jm = jsvec.device_maps(st, jnp.float64)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    return st, jm, tm, np.array(jsvec.pool_from_svec(jnp.asarray(x), jm))


@pytest.mark.parametrize(
    "method,pack_to",
    [("jacobi", 0), ("poly", 0), ("jacobi", 8), ("poly", 8), ("poly", 128),
     ({0: "eigh", 1: "jacobi", 2: "poly"}, 0), ({0: "poly"}, 128)],
    ids=["jacobi", "poly", "jacobi_packed", "poly_packed", "poly_pack128", "dict", "dict_pack128"],
)
def test_methods_match_jax(method, pack_to):
    st, jm, tm, pool = _pools(MIXED_BLK + [("s", 12), ("s", 9)], pack_to)
    assert any(bk.packed for bk in st.buckets) == bool(pack_to)
    if pack_to == 128:
        assert [bk.n for bk in st.buckets] == [1, 128]
    pj = np.asarray(jproj.psd_project_pool(jnp.asarray(pool), jm, method=method))
    pt = tproj.psd_project_pool(torch.as_tensor(pool), tm, method=method).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10 * np.abs(pool).max())


@pytest.mark.parametrize("method", ["poly", "jacobi"])
def test_unported_methods_raise(method):
    """No method is left unported at any block size: a bucket past n = 64
    projects through "jacobi" and "poly" as the JAX package projects it."""
    st, jm, tm, pool = _pools([("s", 3), ("s", 70)], 0)
    assert max(bk.n for bk in st.buckets) > 64
    pj = np.asarray(jproj.psd_project_pool(jnp.asarray(pool), jm, method=method))
    pt = tproj.psd_project_pool(torch.as_tensor(pool), tm, method=method).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10 * np.abs(pool).max())


@pytest.mark.parametrize("method", ["jacobi", "poly"])
def test_non_finite_block_stays_non_finite(method):
    """The jacobi and poly routes mask nothing: a non-finite block comes out
    non-finite, the other blocks as they would without it."""
    st = BlockStructure([("s", 3), ("s", 3), ("s", 2)], "exact", 64, 0)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    svec = torch.as_tensor(np.random.default_rng(1).standard_normal(st.vec_len))
    x = tsvec.pool_from_svec(svec, tm)  # symmetric blocks, as the solver's
    ref = tproj.psd_project_pool(x, tm, method=method)
    x[4] = float("inf")  # diagonal entry of the first 3x3 block
    out = tproj.psd_project_pool(x, tm, method=method)
    assert not torch.isfinite(out[4:13]).all() and torch.isfinite(out[:4]).all()
    torch.testing.assert_close(out[:4], ref[:4], rtol=0, atol=0)
    torch.testing.assert_close(out[13:], ref[13:], rtol=0, atol=0)


def test_non_finite_block_stays_nan():
    """torch's eigh raises on NaN input where XLA's returns NaN; the port
    keeps NaN on the bad block only, so the driver's divergence guard sees
    it and every other block is projected as usual."""
    st = BlockStructure([("s", 3), ("s", 3), ("s", 2)], "exact", 64, 0)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(st.pool_len))
    ref = tproj.psd_project_pool(x, tm)
    x[4] = float("nan")  # first 3x3 block (buckets are ordered by size: 2x2 first)
    out = tproj.psd_project_pool(x, tm)
    assert torch.isnan(out[4:13]).all() and not torch.isnan(out[:4]).any()
    torch.testing.assert_close(out[:4], ref[:4], rtol=0, atol=0)
    torch.testing.assert_close(out[13:], ref[13:], rtol=0, atol=0)


# ----------------------------------------------------------------------
# psd_project (svec coordinates), eigh_by_bucket, and the shared bucket step.
# ----------------------------------------------------------------------

PROJ_BLK = MIXED_BLK + [("s", 12), ("s", 9)]


def _svec(pack_to, seed=11):
    st = BlockStructure(PROJ_BLK, "pow2", 64, pack_to)
    x = np.random.default_rng(seed).standard_normal(st.vec_len) * 3
    return st, jsvec.device_maps(st, jnp.float64), tsvec.device_maps(st, torch.float64, CPU), x


@pytest.mark.parametrize(
    "method,pack_to,eig_rank",
    [("eigh", 0, None), ("jacobi", 0, None), ("poly", 0, None), ("eigh", 0, 2), ("eigh", 8, None),
     ("poly", 8, None), ({0: "eigh", 1: "jacobi", 2: "poly"}, 0, None), ({1: "jacobi"}, 8, None)],
    ids=["eigh", "jacobi", "poly", "eig_rank2", "eigh_packed", "poly_packed", "dict", "dict_packed"],
)
def test_psd_project_matches_jax(method, pack_to, eig_rank):
    """psd_project against the JAX psd_project in f64 (its jacobi on the
    CPU through its plain path, as its own tests run it): within 1e-10 of
    the largest |entry|."""
    st, jm, tm, x = _svec(pack_to)
    pj = np.asarray(jproj.psd_project(jnp.asarray(x), jm, eig_rank=eig_rank, method=method))
    pt = tproj.psd_project(torch.as_tensor(x), tm, eig_rank=eig_rank, method=method).numpy()
    assert pt.shape == (st.vec_len,)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10 * np.abs(x).max())


@pytest.mark.parametrize("method", ["eigh", "jacobi", "poly"])
def test_psd_project_matches_the_pool_route(method):
    """psd_project(x) = svec_from_pool(psd_project_pool(pool_from_svec(x)))
    without packing (no norm equalization to differ by), to 1e-10."""
    st, _, tm, x = _svec(0)
    xt = torch.as_tensor(x)
    direct = tproj.psd_project(xt, tm, method=method)
    pooled = tsvec.svec_from_pool(tproj.psd_project_pool(tsvec.pool_from_svec(xt, tm), tm, method=method), tm)
    torch.testing.assert_close(direct, pooled, rtol=0, atol=1e-10 * np.abs(x).max())
    free = torch.as_tensor(np.asarray(st.free_pos))
    assert torch.equal(direct[free], xt[free])  # the free cone passes through


@pytest.mark.parametrize("method", ["eigh", "poly", "jacobi"])
@pytest.mark.parametrize("pool", [False, True], ids=["svec", "pool"])
def test_eigh_by_bucket_matches_jax(method, pool):
    """An eigh_by_bucket entry replaces its bucket's decomposition; under
    "poly" it makes that bucket decompose and reconstruct (the JAX
    semantics, cuadmm_tpu/ops/projection.py:87-103), with the port's eigh
    (xla_eigh's counterpart) and jacobi_eigh as overrides."""
    from cuadmm_tpu.ops import jacobi as jjac

    from cuadmm_tpu_torch.ops import jacobi as tjac

    st, jm, tm, x = _svec(0)
    assert len(st.buckets) > 3
    jo, to = {1: jproj.xla_eigh, 3: jjac.jacobi_eigh}, {1: tproj.eigh, 3: tjac.jacobi_eigh}
    if pool:
        xin = np.array(jsvec.pool_from_svec(jnp.asarray(x), jm))
        pj = np.asarray(jproj.psd_project_pool(jnp.asarray(xin), jm, eigh_by_bucket=jo, method=method))
        pt = tproj.psd_project_pool(torch.as_tensor(xin), tm, eigh_by_bucket=to, method=method).numpy()
    else:
        pj = np.asarray(jproj.psd_project(jnp.asarray(x), jm, eigh_by_bucket=jo, method=method))
        pt = tproj.psd_project(torch.as_tensor(x), tm, eigh_by_bucket=to, method=method).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10 * np.abs(x).max())
    if method == "poly":  # the overridden buckets differ from the filter's result
        plain = tproj.psd_project(torch.as_tensor(x), tm, method="poly").numpy()
        assert not np.array_equal(plain, tproj.psd_project(torch.as_tensor(x), tm, eigh_by_bucket=to,
                                                           method="poly").numpy())


def test_eigh_returns_nan_for_a_non_finite_block():
    """``eigh``: torch.linalg.eigh's values, and NaN in w and v of a block
    with a non-finite entry (where torch raises and XLA returns NaN)."""
    a = torch.as_tensor(np.random.default_rng(2).standard_normal((3, 4, 4)))
    a = a + a.mT
    w0, v0 = torch.linalg.eigh(a)
    a[1, 2, 0] = float("inf")
    w, v = tproj.eigh(a)
    assert torch.isnan(w[1]).all() and torch.isnan(v[1]).all()
    for i in (0, 2):
        assert torch.equal(w[i], w0[i]) and torch.equal(v[i], v0[i])


def test_psd_project_pool_bitwise_as_before():
    """psd_project_pool's per-bucket step moved into a helper shared with
    psd_project: its results are bit for bit those stored from the port
    before the move (tests/data/torch_psd_project_pool.json), per method."""
    stored = json.loads((Path(__file__).parent / "data" / "torch_psd_project_pool.json").read_text())
    cases = {"eigh": ("eigh", 0, None), "eigh_rank2": ("eigh", 0, 2), "jacobi": ("jacobi", 0, None),
             "poly": ("poly", 0, None), "dict": ({0: "eigh", 1: "jacobi", 2: "poly"}, 0, None),
             "eigh_packed": ("eigh", 8, None), "poly_packed": ("poly", 8, None)}
    assert set(cases) == set(stored)
    for name, (method, pack_to, rank) in cases.items():
        st = BlockStructure(PROJ_BLK, "pow2", 64, pack_to)
        tm = tsvec.device_maps(st, torch.float64, CPU)
        pool = tsvec.pool_from_svec(torch.as_tensor(np.random.default_rng(11).standard_normal(st.vec_len) * 3), tm)
        got = tproj.psd_project_pool(pool, tm, eig_rank=rank, method=method)
        assert [float(v).hex() for v in got.numpy()] == stored[name], name
