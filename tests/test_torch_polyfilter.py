"""Polynomial-filter PSD projection of the port against
cuadmm_tpu.ops.polyfilter (f64, the same schedules, 1e-10), by both of the
port's routes: the batched full-GEMM route and the one-triangle route of a
single large matrix (syrk/syrkx and the mirror pass, ops/sym_products.py).

The JAX package is imported inside the tests that compare with it, so the
tests marked ``cuda`` run on the card's machine, which has no jax:
``python -m pytest --noconftest -m cuda tests/test_torch_polyfilter.py``.
"""

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.ops import polyfilter as tpoly
from cuadmm_tpu_torch.ops import projection as tproj
from cuadmm_tpu_torch.ops import sym_products
from cuadmm_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

F32_TOL = 1e-5  # of the largest entry: the f32 projection's tolerance in tests/test_torch_f32.py
# The card against the CPU in f32 at n up to 2004, of the largest entry:
# sums of n terms in another order, which the filter's steep slope near a
# zero eigenvalue amplifies (poly_ab.py's route check).
F32_CARD_TOL = 5e-5


@pytest.fixture
def jpoly():
    pytest.importorskip("jax.numpy")
    from cuadmm_tpu.ops import polyfilter

    return polyfilter


@pytest.fixture
def tri_min_8(monkeypatch):
    """The one-triangle route from n = 8, so that small matrices take it."""
    monkeypatch.setattr(tpoly, "TRI_MIN_N", dict.fromkeys(tpoly.TRI_MIN_N, 8))


def random_sym(b, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, n, n)) * scale
    return (m + np.swapaxes(m, 1, 2)) / 2


def _jnp(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_schedules_are_the_jax_packages(jpoly):
    assert tpoly.SIGN_SCHEDULE_F64 == jpoly.SIGN_SCHEDULE_F64
    assert tpoly.SIGN_SCHEDULE_F32 == jpoly.SIGN_SCHEDULE_F32
    assert tpoly.default_schedule(torch.float64) is tpoly.SIGN_SCHEDULE_F64
    assert tpoly.default_schedule(torch.float32) is tpoly.SIGN_SCHEDULE_F32


@pytest.mark.parametrize("n,scale", [(2, 1.0), (5, 1e-3), (16, 10.0), (33, 1.0)])
def test_psd_project_poly_matches_jax(jpoly, n, scale):
    mats = random_sym(9, n, seed=n, scale=scale)
    pj = np.asarray(jpoly.psd_project_poly(_jnp(mats)))
    pt = tpoly.psd_project_poly(torch.as_tensor(mats)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10 * np.abs(mats).max())


def test_matrix_sign_and_spectral_scale_match_jax(jpoly):
    mats = random_sym(6, 16, seed=2)
    s_j = np.asarray(jpoly.spectral_scale(_jnp(mats)))
    s_t = tpoly.spectral_scale(torch.as_tensor(mats)).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-14, atol=0)
    y = mats / s_t[:, None, None]
    z_j = np.asarray(jpoly.matrix_sign(_jnp(y)))
    z_t = tpoly.matrix_sign(torch.as_tensor(y)).numpy()
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=1e-10)


def test_block_diagonal_padding_stays_zero():
    """Packed super-matrices: zero rows and columns stay exactly zero and
    each diagonal block is projected on its own."""
    a, b = random_sym(1, 3, seed=7)[0], random_sym(1, 4, seed=8)[0]
    big = np.zeros((1, 9, 9))
    big[0, :3, :3], big[0, 3:7, 3:7] = a, b
    out = tpoly.psd_project_poly(torch.as_tensor(big)).numpy()[0]
    assert np.all(out[7:, :] == 0) and np.all(out[:, 7:] == 0)
    for blk, sl in ((a, slice(0, 3)), (b, slice(3, 7))):
        w, v = np.linalg.eigh(blk)
        exact = (v * np.maximum(w, 0)) @ v.T
        np.testing.assert_allclose(out[sl, sl], exact, rtol=0, atol=1e-10)


def test_non_finite_block_stays_non_finite():
    mats = random_sym(3, 4, seed=1)
    mats[1, 2, 2] = np.inf
    out = tpoly.psd_project_poly(torch.as_tensor(mats))
    assert not bool(torch.isfinite(out[1]).all())
    assert bool(torch.isfinite(out[[0, 2]]).all())


# ----------------------------------------------------------------------
# The one-triangle route
# ----------------------------------------------------------------------

ROUTE_CASES = [(16, "float64"), (40, "float64"), (64, "float64"), (24, "float32"), (48, "float32")]


@pytest.mark.parametrize("n,dtype", ROUTE_CASES)
def test_triangle_route_matches_jax(jpoly, tri_min_8, n, dtype):
    """Batch 1 at n >= TRI_MIN_N: psd_project_poly and matrix_sign by the
    triangle route against the JAX filter, f64 to 1e-10 and f32 to the f32
    projection's tolerance, both of the largest entry."""
    import jax

    mats = random_sym(1, n, seed=n, scale=3.0).astype(dtype)
    x = torch.as_tensor(mats)
    assert tpoly.one_triangle(x)
    tol = 1e-10 if dtype == "float64" else F32_TOL
    with jax.default_matmul_precision("highest"):
        pj = np.asarray(jpoly.psd_project_poly(_jnp(mats)))
        s = np.asarray(jpoly.spectral_scale(_jnp(mats)))[:, None, None]
        zj = np.asarray(jpoly.matrix_sign(_jnp(mats / s)))
    pt = tpoly.psd_project_poly(x)
    zt = tpoly.matrix_sign(x / tpoly.spectral_scale(x)[:, None, None])
    assert pt.dtype == x.dtype and pt.shape == x.shape
    np.testing.assert_allclose(pt.numpy(), pj, rtol=0, atol=tol * np.abs(mats).max())
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0, atol=tol)


@pytest.mark.parametrize("n,dtype", ROUTE_CASES)
def test_triangle_route_is_exactly_symmetric(tri_min_8, n, dtype):
    x = torch.as_tensor(random_sym(1, n, seed=3 * n).astype(dtype))
    p = tpoly.psd_project_poly(x)[0]
    z = tpoly.matrix_sign(x / tpoly.spectral_scale(x)[:, None, None])[0]
    assert torch.equal(p, p.mT) and torch.equal(z, z.mT)


def test_triangle_route_keeps_padding_zero_and_blocks_apart(tri_min_8):
    """A packed super-matrix of one matrix on the route: zero rows and
    columns stay exactly zero, each block is projected on its own."""
    a, b = random_sym(1, 5, seed=17)[0], random_sym(1, 6, seed=18)[0]
    big = np.zeros((1, 16, 16))
    big[0, :5, :5], big[0, 5:11, 5:11] = a, b
    x = torch.as_tensor(big)
    assert tpoly.one_triangle(x)
    out = tpoly.psd_project_poly(x).numpy()[0]
    assert np.all(out[11:, :] == 0) and np.all(out[:, 11:] == 0)
    assert np.all(out[:5, 5:] == 0) and np.all(out[5:, :5] == 0)
    for blk, sl in ((a, slice(0, 5)), (b, slice(5, 11))):
        w, v = np.linalg.eigh(blk)
        np.testing.assert_allclose(out[sl, sl], (v * np.maximum(w, 0)) @ v.T, rtol=0, atol=1e-10)


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_triangle_route_non_finite_stays_non_finite(tri_min_8, bad):
    mats = random_sym(1, 12, seed=5)
    mats[0, 2, 7] = mats[0, 7, 2] = bad
    x = torch.as_tensor(mats)
    assert tpoly.one_triangle(x)
    assert not bool(torch.isfinite(tpoly.psd_project_poly(x)).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_route_selection_by_shape(dtype):
    """Batch 1 at or above TRI_MIN_N of its dtype takes the route; a smaller
    n, a batch, a row mesh and another dtype do not."""
    n = tpoly.TRI_MIN_N[dtype]
    meta = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    one = meta(1, n, n)
    assert tpoly.one_triangle(one)
    assert tpoly.one_triangle(one[0])
    assert not tpoly.one_triangle(meta(1, n - 1, n - 1))
    assert not tpoly.one_triangle(meta(2, n, n))
    assert not tpoly.one_triangle(meta(1, n, n, dt=torch.float16))
    assert not tpoly.one_triangle(one, Mesh(rank=0, size=2, device=torch.device("cpu")))
    assert tpoly.one_triangle(one, Mesh(rank=0, size=1, device=torch.device("cpu")))


def test_route_taken_only_by_single_matrix_buckets(tri_min_8):
    """In psd_project_pool: a bucket of one large matrix makes triangle
    products, a batched bucket makes none (the same projection either
    way)."""
    from cuadmm_tpu_torch.ops import svec as tsvec
    from cuadmm_tpu_torch.structure import BlockStructure

    for blocks, products in (([("s", 12)], 40), ([("s", 12), ("s", 12)], 0)):
        st = BlockStructure(blocks, "pow2", 64, 0)
        maps = tsvec.device_maps(st, torch.float64, torch.device("cpu"))
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(st.vec_len))
        pool = tsvec.pool_from_svec(x, maps)
        before = trace.COUNTS["poly_tri_products"]
        got = tproj.psd_project_pool(pool, maps, method="poly")
        assert trace.COUNTS["poly_tri_products"] - before == products
        ref = tproj.psd_project_pool(pool, maps, method="eigh")
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-10 * float(pool.abs().max()))


@pytest.mark.parametrize("dtype,products", [(torch.float64, 40), (torch.float32, 28)])
def test_tri_products_counted(tri_min_8, dtype, products):
    """13 steps of three products and the last (f64), 9 and the last (f32);
    the plain mirror on the CPU launches no kernel, so counts none."""
    x = torch.as_tensor(random_sym(1, 20, seed=9)).to(dtype)
    before, mirrors = trace.COUNTS["poly_tri_products"], trace.COUNTS["sym_mirror"]
    tpoly.psd_project_poly(x)
    assert trace.COUNTS["poly_tri_products"] - before == products
    assert trace.COUNTS["sym_mirror"] == mirrors
    before = trace.COUNTS["poly_tri_products"]
    tpoly.psd_project_poly(torch.as_tensor(random_sym(2, 20, seed=9)).to(dtype))
    assert trace.COUNTS["poly_tri_products"] == before


def test_c0_step_folds_into_the_square(tri_min_8, monkeypatch):
    """A step with c = 0 (P = a I + b A from the square's own mirror pass)
    makes two products and agrees with the full route."""
    sched = ((1.5, -0.5, 0.0), (1.875, -1.25, 0.375))
    x = torch.as_tensor(random_sym(1, 24, seed=6))
    y = x / tpoly.spectral_scale(x)[:, None, None]
    before = trace.COUNTS["poly_tri_products"]
    tri = tpoly.matrix_sign(y, sched)
    assert trace.COUNTS["poly_tri_products"] - before == 5
    monkeypatch.setattr(tpoly, "TRI_MIN_N", dict.fromkeys(tpoly.TRI_MIN_N, 1 << 62))
    full = tpoly.matrix_sign(y, sched)
    np.testing.assert_allclose(tri.numpy(), full.numpy(), rtol=0, atol=1e-13)


def test_mirror_plain_reads_the_upper_triangle_only():
    """mirror (its plain version on the CPU): NaN below the diagonal of T
    and W does not leak; scale, shift and W are folded in; in place works."""
    rng = np.random.default_rng(1)
    t, w = (torch.as_tensor(random_sym(1, 7, seed=k)[0]) for k in (1, 2))
    nan_low = torch.full((7, 7), float("nan"), dtype=torch.float64).tril_(-1)
    s = torch.tensor([[[0.25]]], dtype=torch.float64)
    out = sym_products.mirror(t + nan_low, torch.empty_like(t), alpha=2.0, scale=s, shift=3.0,
                              add=w + nan_low, add_coef=-0.5)
    expect = 0.5 * (t - 0.5 * w) + 3.0 * torch.eye(7, dtype=torch.float64)
    torch.testing.assert_close(out, expect, rtol=0, atol=1e-15)
    inplace = t + nan_low
    assert sym_products.mirror(inplace, shift=float(rng.standard_normal())) is inplace
    assert bool(torch.isfinite(inplace).all()) and torch.equal(inplace, inplace.mT)


def test_products_write_the_upper_triangle():
    a = torch.as_tensor(random_sym(1, 9, seed=11)[0])
    b = a @ a
    up = torch.ones(9, 9, dtype=torch.bool).triu()
    torch.testing.assert_close(sym_products.syrk(a, torch.empty_like(a), alpha=-2.0)[up], (-2.0 * a @ a.mT)[up])
    torch.testing.assert_close(sym_products.syrkx(a, b, torch.empty_like(a))[up], (a @ b.mT)[up])
    with pytest.raises(ValueError):
        sym_products.syrk(a, a)


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuBLAS's syrk/syrkx and the mirror kernel run only there")


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(504, torch.float64), (2004, torch.float64), (1500, torch.float32)])
def test_card_route_matches_plain_and_replays(n, dtype):
    """The triangle route on the card against its plain version on the CPU
    (the same polynomial, f64 to 1e-10 and f32 to F32_CARD_TOL of the
    largest entry), exactly symmetric; a captured CUDA graph's replay equals the
    eager call bit for bit; 40 (f64) or 28 (f32) triangle products, and as
    many mirror-kernel launches."""
    _needs_card()
    from cuadmm_tpu_torch.device import resolve_device

    resolve_device("cuda")
    assert tpoly.one_triangle(torch.empty((1, n, n), dtype=dtype, device="meta"))
    x_cpu = torch.as_tensor(random_sym(1, n, seed=n)).to(dtype)
    x = x_cpu.cuda()
    before = dict(trace.COUNTS)
    eager = tpoly.psd_project_poly(x)
    torch.cuda.synchronize()
    products = 40 if dtype == torch.float64 else 28
    assert trace.COUNTS["poly_tri_products"] - before["poly_tri_products"] == products
    assert trace.COUNTS["sym_mirror"] - before["sym_mirror"] == products
    plain = tpoly.psd_project_poly(x_cpu)
    tol = 1e-10 if dtype == torch.float64 else F32_CARD_TOL
    torch.testing.assert_close(eager.cpu(), plain, rtol=0, atol=tol * float(x_cpu.abs().max()))
    assert torch.equal(eager[0], eager[0].mT)

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = tpoly.psd_project_poly(x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_card_mirror_matches_plain(dtype):
    """The mirror kernel against mirror_ref at ragged and whole tiles, in
    place, with NaN below the diagonal of T and W."""
    _needs_card()
    for n in (1, 33, 64, 2004):
        t = torch.as_tensor(random_sym(1, n, seed=n)[0]).to(dtype).cuda()
        w = torch.as_tensor(random_sym(1, n, seed=n + 1)[0]).to(dtype).cuda()
        s = torch.tensor([[[0.37]]], dtype=dtype, device="cuda")
        ref = sym_products.mirror_ref(t.cpu(), torch.empty_like(t.cpu()), 0.5, s.cpu(), -2.0, w.cpu(), 1.5)
        nan_low = torch.full_like(t, float("nan")).tril_(-1)
        got = sym_products.mirror(t + nan_low, alpha=0.5, scale=s, shift=-2.0, add=w + nan_low, add_coef=1.5)
        torch.cuda.synchronize()
        tol = 1e-15 if dtype == torch.float64 else 1e-6
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=tol * float(ref.abs().max()))
        assert torch.equal(got, got.mT)
