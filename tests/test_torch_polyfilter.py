"""Polynomial-filter PSD projection of the port against
cuadmm_tpu.ops.polyfilter (f64, the same schedules, 1e-10)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from cuadmm_tpu.ops import polyfilter as jpoly

from cuadmm_tpu_torch.ops import polyfilter as tpoly

torch.set_num_threads(1)


def random_sym(b, n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, n, n)) * scale
    return (m + np.swapaxes(m, 1, 2)) / 2


def test_schedules_are_the_jax_packages():
    assert tpoly.SIGN_SCHEDULE_F64 == jpoly.SIGN_SCHEDULE_F64
    assert tpoly.SIGN_SCHEDULE_F32 == jpoly.SIGN_SCHEDULE_F32
    assert tpoly.default_schedule(torch.float64) is tpoly.SIGN_SCHEDULE_F64
    assert tpoly.default_schedule(torch.float32) is tpoly.SIGN_SCHEDULE_F32


@pytest.mark.parametrize("n,scale", [(2, 1.0), (5, 1e-3), (16, 10.0), (33, 1.0)])
def test_psd_project_poly_matches_jax(n, scale):
    mats = random_sym(9, n, seed=n, scale=scale)
    pj = np.asarray(jpoly.psd_project_poly(jnp.asarray(mats)))
    pt = tpoly.psd_project_poly(torch.as_tensor(mats)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10 * np.abs(mats).max())


def test_matrix_sign_and_spectral_scale_match_jax():
    mats = random_sym(6, 16, seed=2)
    s_j = np.asarray(jpoly.spectral_scale(jnp.asarray(mats)))
    s_t = tpoly.spectral_scale(torch.as_tensor(mats)).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=1e-14, atol=0)
    y = mats / s_t[:, None, None]
    z_j = np.asarray(jpoly.matrix_sign(jnp.asarray(y)))
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
