"""PSD projection of the port against cuadmm_tpu.ops.projection (f64):
the eigh, jacobi and poly methods, a per-bucket dict, and packing."""

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
