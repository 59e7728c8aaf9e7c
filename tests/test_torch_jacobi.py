"""Batched Jacobi eigh (K4): the port's plain version and wrapper against
cuadmm_tpu.ops.jacobi.

``jacobi_eigh_ref`` takes the JAX package's pair order, sweep count and
rotation formula, so its unsorted w and v agree with ``jacobi_eigh_jnp``
to rounding (1e-9 in f64). The CUDA kernel runs only on a card: its test
is marked ``cuda`` and runs with
``python -m pytest --noconftest -m cuda tests/test_torch_jacobi.py``.
"""

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch.ops import jacobi as tj
from cuadmm_tpu_torch.ops.launches import LAUNCHES

torch.set_num_threads(1)


def random_sym(b, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((b, n, n)).astype(dtype)
    return (m + np.swapaxes(m, 1, 2)) / 2


def degenerate():
    """Zero, repeated-eigenvalue and rank-3 matrices (tests/test_jacobi.py:57-64)."""
    mats = np.zeros((3, 6, 6))
    mats[1] = np.eye(6) * 2.0
    q, _ = np.linalg.qr(np.random.default_rng(0).standard_normal((6, 6)))
    mats[2] = (q[:, :3] * 1.5) @ q[:, :3].T
    return mats


def check_eigh(mats, w, v, tol):
    """A v_i = w_i v_i, V orthogonal, sorted w equal to numpy's."""
    w, v = np.asarray(w, np.float64), np.asarray(v, np.float64)
    b, n, _ = mats.shape
    scale = np.abs(mats).max() + 1.0
    assert np.abs(np.einsum("bij,bj,bkj->bik", v, w, v) - mats).max() < tol * scale
    assert np.abs(np.einsum("bji,bjk->bik", v, v) - np.eye(n)).max() < tol
    assert np.abs(np.sort(w, axis=1) - np.linalg.eigvalsh(mats)).max() < tol * scale


@pytest.mark.parametrize(
    "mats",
    [random_sym(17, n, seed=n) for n in (2, 3, 4, 8, 16)] + [degenerate()],
    ids=["n2", "n3", "n4", "n8", "n16", "degenerate"],
)
def test_ref_matches_jnp_f64(mats):
    jjac = pytest.importorskip("cuadmm_tpu.ops.jacobi")
    import jax.numpy as jnp

    wj, vj = (np.asarray(a) for a in jjac.jacobi_eigh_jnp(jnp.asarray(mats)))
    wt, vt = (a.numpy() for a in tj.jacobi_eigh_ref(torch.as_tensor(mats)))
    # Same rotations in the same order: unsorted w and v agree elementwise.
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-9)
    n = mats.shape[-1]
    unique = np.min(np.diff(np.sort(wj, axis=1), axis=1), axis=1) > 1e-6
    diagonal = np.all(mats * (1 - np.eye(n)) == 0, axis=(1, 2))  # no rotation at all
    # Where an eigenvalue repeats in a matrix that is not diagonal, its
    # eigenvectors are any basis of the eigenspace: the rotations there act
    # on rounding noise, so the two bases differ; the projector onto the
    # nonnegative part must not.
    exact = unique | diagonal
    np.testing.assert_allclose(vt[exact], vj[exact], rtol=0, atol=1e-9)
    proj = lambda w, v: np.einsum("bij,bj,bkj->bik", v, np.maximum(w, 0), v)
    np.testing.assert_allclose(proj(wt, vt), proj(wj, vj), rtol=0, atol=1e-9)
    check_eigh(mats, wt, vt, 1e-9)


@pytest.mark.parametrize("n", [65, 80, 128])
def test_ref_matches_jnp_past_64(n):
    """Every block size, as the JAX package takes it: two sweeps (a full
    run at n = 128 is ~100k rotations per package), unsorted w and v within
    1e-9, and the wrapper on a CPU tensor returns the plain version."""
    jjac = pytest.importorskip("cuadmm_tpu.ops.jacobi")
    import jax.numpy as jnp

    mats = random_sym(2, n, seed=n)
    wj, vj = (np.asarray(a) for a in jjac.jacobi_eigh_jnp(jnp.asarray(mats), sweeps=2))
    wt, vt = tj.jacobi_eigh(torch.as_tensor(mats), sweeps=2)
    np.testing.assert_allclose(wt.numpy(), wj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=0, atol=1e-9)


def test_unconverged_sweeps_amplify_rounding():
    """Why the card compares K4 with its plain version only at full sweeps:
    after two sweeps at n = 80 a relative input change of 1e-7 moves the
    plain version's sorted f32 eigenvalues by 1.6e-3, 4e-4 of the largest
    entry and eight times the f32 tolerance (two runs that round
    differently move them as much), while a converged run moves them by
    less than 1e-5 of it."""
    mats = random_sym(2, 80, seed=80)
    noise = 1 + 1e-7 * np.random.default_rng(1).standard_normal(mats.shape)
    moved = (mats * noise + np.swapaxes(mats * noise, 1, 2)) / 2
    sorted_w = lambda m, sw: np.sort(tj.jacobi_eigh_ref(torch.as_tensor(m, dtype=torch.float32), sw)[0].numpy(), 1)
    assert np.abs(sorted_w(mats, 2) - sorted_w(moved, 2)).max() > 2e-4 * np.abs(mats).max()
    small, small_moved = mats[:, :24, :24], moved[:, :24, :24]
    assert np.abs(sorted_w(small, None) - sorted_w(small_moved, None)).max() < 1e-5 * np.abs(small).max()


def test_plain_f32_error_grows_with_n():
    """Why the card's f32 tolerance grows past n = 64 (5e-5 n/32): the plain
    version's own f32 eigenvalues, against the f64 ones of the same input,
    are off by about 4e-5 of the largest entry at n = 64, inside 5e-5, and
    9e-5 at 128, past it."""
    err = {}
    for n in (64, 128):
        mats = random_sym(2, n, seed=n, dtype=np.float32)
        w = tj.jacobi_eigh_ref(torch.as_tensor(mats))[0].numpy()
        exact = np.linalg.eigvalsh(mats.astype(np.float64))
        err[n] = np.abs(np.sort(w, 1) - exact).max() / np.abs(mats).max()
    assert 5e-5 * 0.5 < err[64] <= 5e-5
    assert 5e-5 < err[128] <= 5e-5 * 128 / 32


def test_ref_f32_matches_pallas_interpret():
    jjac = pytest.importorskip("cuadmm_tpu.ops.jacobi")
    import jax.numpy as jnp

    mats = random_sym(7, 4, seed=3, dtype=np.float32)
    wp, vp = jjac.jacobi_eigh_pallas(jnp.asarray(mats), interpret=True, batch_tile=8)
    wt, vt = tj.jacobi_eigh_ref(torch.as_tensor(mats))
    assert wt.dtype == vt.dtype == torch.float32
    np.testing.assert_allclose(wt.numpy(), np.asarray(wp), rtol=0, atol=5e-5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vp), rtol=0, atol=5e-5)
    check_eigh(mats, wt.numpy(), vt.numpy(), 5e-5)


def test_schedule_and_sweeps_match_jax():
    jjac = pytest.importorskip("cuadmm_tpu.ops.jacobi")
    for n in range(1, 70):
        assert tj.default_sweeps(n) == jjac.default_sweeps(n)
        assert tj._pair_schedule(n) == [tuple(map(int, pq)) for pq in jjac._pair_schedule(n)]


def test_one_by_one_and_empty_batch():
    mats = torch.as_tensor(random_sym(5, 1, seed=2))
    w, v = tj.jacobi_eigh(mats)
    torch.testing.assert_close(w, mats[:, :, 0], rtol=0, atol=0)
    torch.testing.assert_close(v, torch.ones_like(mats), rtol=0, atol=0)
    w, v = tj.jacobi_eigh(torch.zeros(0, 4, 4, dtype=torch.float64))
    assert w.shape == (0, 4) and v.shape == (0, 4, 4)


@pytest.mark.parametrize("where", [(0, 1), (1, 1), (2, 3)], ids=["off_diag", "diag", "last"])
def test_non_finite_stays_non_finite(where):
    """No masking on this route: a NaN in a block makes that block's w or v
    NaN (as XLA's eigh does), so the driver's divergence guard fires; the
    other blocks are untouched."""
    mats = random_sym(3, 4, seed=5)
    i, j = where
    mats[1, i, j] = mats[1, j, i] = np.nan
    w, v = tj.jacobi_eigh(torch.as_tensor(mats))
    bad = ~(torch.isfinite(w).all(dim=1) & torch.isfinite(v).all(dim=(1, 2)))
    assert bad.tolist() == [False, True, False]
    clean = tj.jacobi_eigh_ref(torch.as_tensor(mats[[0, 2]]))
    torch.testing.assert_close(w[[0, 2]], clean[0], rtol=0, atol=0)


def test_cpu_tensors_launch_nothing():
    mats = torch.as_tensor(random_sym(4, 5, seed=1))
    before = LAUNCHES["k4"]
    w, v = tj.jacobi_eigh(mats)
    assert LAUNCHES["k4"] == before
    wr, vr = tj.jacobi_eigh_ref(mats)
    torch.testing.assert_close(w, wr, rtol=0, atol=0)
    torch.testing.assert_close(v, vr, rtol=0, atol=0)


@pytest.mark.parametrize(
    "mats,err",
    [
        (torch.zeros(2, 3, 4, dtype=torch.float64), ValueError),  # not square
        (torch.zeros(3, 3, dtype=torch.float64), ValueError),  # not batched
        (torch.zeros(2, 3, 3, dtype=torch.float16), TypeError),
        (torch.empty(2, 3, 3, dtype=torch.float64, device="meta"), ValueError),
    ],
    ids=["square", "batched", "f16", "meta_device"],
)
def test_wrapper_rejects(mats, err):
    before = LAUNCHES["k4"]
    with pytest.raises(err):
        tj.jacobi_eigh(mats)
    assert LAUNCHES["k4"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "n,batch", [(2, 80), (5, 598), (13, 182), (32, 49), (45, 11), (64, 11), (80, 11), (128, 56)]
)
def test_kernel_matches_plain_on_card(n, batch, dtype):
    """Full sweeps at every n: after two sweeps the iteration is far from
    converged and amplifies rounding (test_unconverged_sweeps_amplify_
    rounding), so only a converged run compares the kernel with its plain
    version.
    Tolerance 1e-10 in f64; 5e-5 in f32 up to n = 64 and 5e-5 n/32 past
    it, as the plain version's own f32 error grows with n (4.0e-5 at
    n = 64, 8.8e-5 at 128). Two launches on the same input agree bit for
    bit."""
    tol = 1e-10 if dtype == torch.float64 else (5e-5 if n <= 64 else 5e-5 * n / 32)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    mats = torch.as_tensor(random_sym(batch, n, seed=n, dtype=np_dtype), device="cuda")
    before = LAUNCHES["k4"]
    w, v = tj.jacobi_eigh(mats)
    torch.cuda.synchronize()
    assert LAUNCHES["k4"] == before + 1
    w2, v2 = tj.jacobi_eigh(mats)
    assert torch.equal(w2, w) and torch.equal(v2, v)
    wr, vr = tj.jacobi_eigh_ref(mats)
    scale = float(mats.abs().max())
    assert float((w.sort(dim=1).values - wr.sort(dim=1).values).abs().max()) <= tol * scale
    proj = (v * w.clamp(min=0)[:, None, :]) @ v.transpose(1, 2)
    proj_r = (vr * wr.clamp(min=0)[:, None, :]) @ vr.transpose(1, 2)
    assert float((proj - proj_r).abs().max()) <= tol * scale
    eye = torch.eye(n, dtype=dtype, device="cuda")
    assert float((v.transpose(1, 2) @ v - eye).abs().max()) <= tol
    # A NaN block stays NaN through the kernel; the others do not.
    bad = mats.clone()
    bad[0, 0, 1] = bad[0, 1, 0] = float("nan")
    wb, vb = tj.jacobi_eigh(bad)
    assert not bool(torch.isfinite(vb[0]).all() and torch.isfinite(wb[0]).all())
    assert bool(torch.isfinite(wb[1:]).all() and torch.isfinite(vb[1:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,dtype", [(130, torch.float64), (130, torch.float32), (200, torch.float64)],
    ids=["n130-f64", "n130-f32", "n200-f64"],
)
def test_kernel_past_128_matches_eigh_on_card(n, dtype):
    """The general loop (n > 128): A in shared memory and V in device
    memory (130, f64 and f32), A streamed from device memory too (200, f64);
    against torch.linalg.eigh in f64 (the plain version takes minutes here),
    within the same tolerances as test_kernel_matches_plain_on_card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    mats = torch.as_tensor(random_sym(3, n, seed=n, dtype=np_dtype), device="cuda")
    w, v = tj.jacobi_eigh(mats)
    we, ve = torch.linalg.eigh(mats.double())
    tol = 1e-10 if dtype == torch.float64 else 5e-5 * n / 32
    scale = float(mats.abs().max())
    assert float((w.double().sort(dim=1).values - we).abs().max()) <= tol * scale
    proj = (v * w.clamp(min=0)[:, None, :]) @ v.transpose(1, 2)
    proj_e = (ve * we.clamp(min=0)[:, None, :]) @ ve.transpose(1, 2)
    assert float((proj.double() - proj_e).abs().max()) <= tol * scale
    eye = torch.eye(n, dtype=dtype, device="cuda")
    assert float((v.transpose(1, 2) @ v - eye).abs().max()) <= tol
