"""Batched Jacobi eigh (K4): the port's plain versions and wrapper against
cuadmm_tpu.ops.jacobi.

``jacobi_eigh_ref`` takes the JAX package's pair order, sweep count and
rotation formula, so its unsorted w and v agree with ``jacobi_eigh_jnp``
to rounding (1e-9 in f64). ``jacobi_eigh_parallel_ref``, the plain version
of the kernel's "cta" plan, runs the same sweeps in the round-robin order,
so it converges to the same eigendecomposition: sorted w, the clamped
projection and V^T V - I within k4_tol. The CUDA kernel runs only on a
card: its tests are marked ``cuda`` and run with
``python -m pytest --noconftest -m cuda tests/test_torch_jacobi.py``.
"""

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch.ops import jacobi as tj
from cuadmm_tpu_torch.trace import COUNTS
from cuadmm_tpu_torch.ops.projection import reconstruct_clamped

H100_SMEM = 232448  # an H100's opt-in shared memory per block

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


@pytest.mark.parametrize("n", list(range(2, 18)) + [64])
def test_parallel_schedule(n):
    """Every step's pairs are disjoint, every pair p < q comes once a sweep,
    in n - 1 steps (n even) or n (n odd: each index waits one step)."""
    steps = tj.parallel_schedule(n)
    assert len(steps) == n - 1 + (n & 1)
    seen = []
    for p, q in steps:
        assert len(p) == len(q) == n // 2
        assert len(set(p + q)) == len(p + q)
        assert all(0 <= a < b < n for a, b in zip(p, q))
        seen += list(zip(p, q))
    assert sorted(seen) == tj._pair_schedule(n)


def _eigh_errors(mats, w, v, wr, vr):
    """Sorted w and the clamped projection, relative to the largest |entry|,
    and V^T V - I."""
    w, v, wr, vr = (torch.as_tensor(np.array(x, np.float64)) for x in (w, v, wr, vr))
    scale = float(np.abs(mats).max())
    dw = float((w.sort(dim=1).values - wr.sort(dim=1).values).abs().max()) / scale
    dp = float((reconstruct_clamped(w, v) - reconstruct_clamped(wr, vr)).abs().max()) / scale
    orth = float((v.transpose(1, 2) @ v - torch.eye(v.shape[-1], dtype=torch.float64)).abs().max())
    return dw, dp, orth


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", [2, 3, 5, 8, 16, 32, 45, 64])
def test_parallel_ref_matches_jnp(n, dtype):
    """The "cta" plan's order against the JAX package's cyclic order, both
    at default_sweeps(n): converged, they agree within k4_tol."""
    jjac = pytest.importorskip("cuadmm_tpu.ops.jacobi")
    import jax.numpy as jnp

    mats = random_sym(5, n, seed=n, dtype=dtype)
    wj, vj = jjac.jacobi_eigh_jnp(jnp.asarray(mats))
    wt, vt = tj.jacobi_eigh_parallel_ref(torch.as_tensor(mats))
    assert wt.dtype == vt.dtype == torch.from_numpy(mats).dtype
    tol = tj.k4_tol(n, torch.float64 if dtype == np.float64 else torch.float32)
    assert max(_eigh_errors(mats, wt, vt, wj, vj)) <= tol


def test_parallel_ref_n128_matches_numpy():
    """The parallel order past the grid's buckets: n = 128 in f64 against
    numpy.linalg.eigh to 1e-10."""
    mats = random_sym(2, 128, seed=128)
    wt, vt = tj.jacobi_eigh_parallel_ref(torch.as_tensor(mats))
    we, ve = np.linalg.eigh(mats)
    assert max(_eigh_errors(mats, wt, vt, we, ve)) <= 1e-10


def test_parallel_ref_non_finite_and_sweeps():
    """A NaN block comes out non-finite and leaves the others alone; zero
    sweeps return the input's diagonal and the identity."""
    mats = random_sym(3, 7, seed=4)
    mats[1, 2, 5] = mats[1, 5, 2] = np.nan
    w, v = tj.jacobi_eigh_parallel_ref(torch.as_tensor(mats))
    bad = ~(torch.isfinite(w).all(dim=1) & torch.isfinite(v).all(dim=(1, 2)))
    assert bad.tolist() == [False, True, False]
    clean = tj.jacobi_eigh_parallel_ref(torch.as_tensor(mats[[0, 2]]))
    torch.testing.assert_close(w[[0, 2]], clean[0], rtol=0, atol=0)
    w0, v0 = tj.jacobi_eigh_parallel_ref(torch.as_tensor(mats), sweeps=0)
    torch.testing.assert_close(w0, torch.as_tensor(np.diagonal(mats, axis1=1, axis2=2).copy()), rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(v0, torch.eye(7, dtype=torch.float64).expand(3, 7, 7), rtol=0, atol=0)


def test_cta_smem_bytes():
    """The "cta" plan's shared memory (csrc/jacobi_eigh.cu, cta_bytes): V^T
    (m x m, m = n rounded up to even), A's packed triangle, two (c, s)
    buffers, the block table."""
    assert tj.cta_smem_bytes(2, 8) == (4 + 3 + 8) * 8 + 2
    assert tj.cta_smem_bytes(64, 8) == (64 * 64 + 64 * 65 // 2 + 4 * 64) * 8 + 2 * (32 * 31 // 2)
    assert tj.cta_smem_bytes(45, 4) == (46 * 46 + 46 * 47 // 2 + 4 * 46) * 4 + 2 * (23 * 22 // 2)
    assert tj.cta_smem_bytes(128, 8) == 205248 <= H100_SMEM  # the grid under pack_to=128
    assert tj.cta_smem_bytes(138, 8) > H100_SMEM >= tj.cta_smem_bytes(136, 8)


def _next_blocks(h):
    """The blocks (i, j) of step pairs i <= j that the kernel gives the next
    step's rotations to (csrc/jacobi_eigh.cu, next_block)."""
    if h == 1:
        return {(0, 0)}
    return {(0, 1), (h - 2, h - 1)} | {(j, j + 2) for j in range(h - 2)}


def _kernel_pairs(step, n):
    """A ``parallel_schedule`` step as the kernel holds it: pair k = slot k,
    and for n odd the dummy index n paired with the index the step leaves
    out, in slot 0."""
    pairs = list(zip(*step))
    if n & 1:
        idle = (set(range(n)) - set(step[0]) - set(step[1])).pop()
        pairs = [(idle, n)] + pairs
    return pairs


@pytest.mark.parametrize("n", list(range(2, 18)) + [45, 64, 128, 254])
def test_next_step_pairs_lie_in_next_blocks(n):
    """The kernel forms step t+1's rotations in the blocks of step t that
    hold their (p, q), and looks only in ``_next_blocks`` for them: every
    pair of every next step lies in one of those blocks."""
    steps = [_kernel_pairs(step, n) for step in tj.parallel_schedule(n)]
    h = (n + (n & 1)) // 2
    for t in range(len(steps)):
        where = {x: k for k, pq in enumerate(steps[t]) for x in pq}
        for p, q in steps[(t + 1) % len(steps)]:
            assert tuple(sorted((where[p], where[q]))) in _next_blocks(h), (n, t, p, q)


@pytest.mark.parametrize(
    "n,batch,dtype,plan",
    [(2, 80, torch.float64, "warp"), (4, 80, torch.float32, "warp"), (5, 64, torch.float64, "warp"),
     (6, 64, torch.float64, "cta"), (7, tj.FEW_BATCH, torch.float32, "cta"),
     (7, tj.FEW_BATCH + 1, torch.float64, "warp"), (6, 1556, torch.float32, "warp"),
     (8, 598, torch.float32, "cta"), (8, 1556, torch.float64, "cta"), (16, 182, torch.float64, "cta"),
     (tj.CTA_MIN_N - 1, 4096, torch.float64, "warp"), (tj.CTA_MIN_N, 4096, torch.float64, "cta"),
     (32, 49, torch.float64, "cta"), (32, 49, torch.float32, "cta"), (45, 11, torch.float64, "cta"),
     (64, 11, torch.float64, "cta"), (64, 11, torch.float32, "cta"), (128, 56, torch.float64, "cta"),
     (136, 1, torch.float64, "cta"), (137, 1, torch.float64, "warp"), (138, 1, torch.float32, "cta"),
     (190, 1, torch.float32, "cta"), (191, 1, torch.float32, "warp"), (300, 1, torch.float32, "warp")],
)
def test_k4_plan(n, batch, dtype, plan):
    """The plan for an H100's shared memory: "warp" below CTA_MIN_N_FEW,
    from there to CTA_MIN_N past FEW_BATCH matrices, and where the "cta"
    plan's V^T and A do not fit (f64 past n = 136, f32 past 190); "cta"
    elsewhere."""
    assert tj.k4_plan(n, batch, dtype, H100_SMEM) == plan


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
    before = COUNTS["k4"]
    w, v = tj.jacobi_eigh(mats)
    assert COUNTS["k4"] == before
    wr, vr = tj.jacobi_eigh_ref(mats)
    torch.testing.assert_close(w, wr, rtol=0, atol=0)
    torch.testing.assert_close(v, vr, rtol=0, atol=0)


@pytest.mark.parametrize("plan", tj.PLANS)
def test_cpu_tensors_take_the_cyclic_plain_version_in_any_plan(plan):
    """A CPU tensor takes jacobi_eigh_ref (the reference's order) whatever
    plan the private ``_plan`` hook names, and launches nothing."""
    mats = torch.as_tensor(random_sym(4, 9, seed=1))
    before = COUNTS["k4"]
    w, v = tj.jacobi_eigh(mats, _plan=plan)
    assert COUNTS["k4"] == before
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
    before = COUNTS["k4"]
    with pytest.raises(err):
        tj.jacobi_eigh(mats)
    assert COUNTS["k4"] == before


def test_wrapper_rejects_unknown_plan():
    before = COUNTS["k4"]
    with pytest.raises(ValueError, match="plan"):
        tj.jacobi_eigh(torch.zeros(2, 3, 3, dtype=torch.float64), _plan="block")
    assert COUNTS["k4"] == before


def _card_plan(n, batch, dtype):
    """The plan ``jacobi_eigh`` picks on this card for this bucket."""
    return tj.k4_plan(n, batch, dtype, tj.card_smem(torch.cuda.current_device()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize(
    "n,batch,plan",
    [(2, 80, "warp"), (5, 598, "warp"), (6, 1556, "warp"), (7, 80, "cta"), (13, 182, "cta"), (32, 49, "cta"),
     (45, 11, "cta"), (64, 11, "cta"), (80, 11, "cta"), (128, 56, "cta")],
)
def test_kernel_matches_plain_on_card(n, batch, plan, dtype):
    """The plan an H100 picks (``plan``) against both plain versions (the
    reference's cyclic order and the "cta" plan's parallel one), at full
    sweeps at every n: after two sweeps the iteration is far from
    converged and amplifies rounding
    (test_unconverged_sweeps_amplify_rounding), so only a converged run
    compares the kernel with a plain version.
    Tolerance 1e-10 in f64; 5e-5 in f32 up to n = 64 and 5e-5 n/32 past
    it, as the plain version's own f32 error grows with n (4.0e-5 at
    n = 64, 8.8e-5 at 128). Two launches on the same input agree bit for
    bit; a NaN block stays NaN and leaves the others finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    tol = tj.k4_tol(n, dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    mats = torch.as_tensor(random_sym(batch, n, seed=n, dtype=np_dtype), device="cuda")
    assert _card_plan(n, batch, dtype) == plan
    scale = float(mats.abs().max())
    eye = torch.eye(n, dtype=dtype, device="cuda")
    bad = mats.clone()
    bad[0, 0, 1] = bad[0, 1, 0] = float("nan")
    before = COUNTS["k4"]
    w, v = tj.jacobi_eigh(mats)
    torch.cuda.synchronize()
    assert COUNTS["k4"] == before + 1
    w2, v2 = tj.jacobi_eigh(mats)
    assert torch.equal(w2, w) and torch.equal(v2, v), plan
    proj = (v * w.clamp(min=0)[:, None, :]) @ v.transpose(1, 2)
    for wr, vr in (tj.jacobi_eigh_ref(mats), tj.jacobi_eigh_parallel_ref(mats)):
        assert float((w.sort(dim=1).values - wr.sort(dim=1).values).abs().max()) <= tol * scale, plan
        proj_r = (vr * wr.clamp(min=0)[:, None, :]) @ vr.transpose(1, 2)
        assert float((proj - proj_r).abs().max()) <= tol * scale, plan
    assert float((v.transpose(1, 2) @ v - eye).abs().max()) <= tol, plan
    wb, vb = tj.jacobi_eigh(bad)
    assert not bool(torch.isfinite(vb[0]).all() and torch.isfinite(wb[0]).all()), plan
    assert bool(torch.isfinite(wb[1:]).all() and torch.isfinite(vb[1:]).all()), plan


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,dtype,plan",
    [(130, torch.float64, "cta"), (130, torch.float32, "cta"), (138, torch.float64, "warp"),
     (200, torch.float64, "warp"), (200, torch.float32, "warp")],
    ids=["n130-f64", "n130-f32", "n138-f64", "n200-f64", "n200-f32"],
)
def test_kernel_past_128_matches_eigh_on_card(n, dtype, plan):
    """Past the grid's buckets, in the plan the card picks: "cta" at 130
    (its shared memory holds f64 to n = 136, f32 to 190), "warp" past that,
    with A in shared memory and V in device memory (138 f64, 200 f32) and A
    streamed from device memory too (200 f64); against torch.linalg.eigh
    in f64 (the plain versions take minutes here), within the same
    tolerances as test_kernel_matches_plain_on_card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    mats = torch.as_tensor(random_sym(3, n, seed=n, dtype=np_dtype), device="cuda")
    we, ve = torch.linalg.eigh(mats.double())
    tol = tj.k4_tol(n, dtype)
    scale = float(mats.abs().max())
    proj_e = (ve * we.clamp(min=0)[:, None, :]) @ ve.transpose(1, 2)
    eye = torch.eye(n, dtype=dtype, device="cuda")
    assert _card_plan(n, 3, dtype) == plan
    w, v = tj.jacobi_eigh(mats)
    assert float((w.double().sort(dim=1).values - we).abs().max()) <= tol * scale
    proj = (v * w.clamp(min=0)[:, None, :]) @ v.transpose(1, 2)
    assert float((proj.double() - proj_e).abs().max()) <= tol * scale
    assert float((v.transpose(1, 2) @ v - eye).abs().max()) <= tol


@pytest.mark.cuda
def test_cta_plan_past_shared_memory_raises_on_card():
    """f64 at n = 200 does not fit the cta plan's shared memory: a launch
    forced into it (the ``_plan`` hook) is refused through the C interface
    and counts nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    mats = torch.as_tensor(random_sym(2, 200, seed=1), device="cuda")
    assert _card_plan(200, 2, torch.float64) == "warp"
    before = COUNTS["k4"]
    with pytest.raises(RuntimeError, match="cta"):
        tj.jacobi_eigh(mats, _plan="cta")
    assert COUNTS["k4"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("n,batch", [(5, 598), (32, 49), (64, 11)])
def test_kernel_graph_replay_matches_eager_on_card(n, batch, dtype):
    """The plan the card picks ("warp" at 5, "cta" at 32 and 64 on an
    H100) captured into a CUDA graph (no allocation or host sync inside the
    launch) and replayed on new input gives the eager call's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    first = torch.as_tensor(random_sym(batch, n, seed=n, dtype=np_dtype), device="cuda")
    second = torch.as_tensor(random_sym(batch, n, seed=n + 1, dtype=np_dtype), device="cuda")
    static = first.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tj.jacobi_eigh(static)  # builds and sets up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        w, v = tj.jacobi_eigh(static)
    static.copy_(second)
    graph.replay()
    torch.cuda.synchronize()
    we, ve = tj.jacobi_eigh(second)
    assert torch.equal(w, we) and torch.equal(v, ve)
