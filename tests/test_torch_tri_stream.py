"""The packed and banded factor (K2, K3) against cuadmm_tpu.ops.tri_stream.

Layouts, meta tables and scatters agree exactly; the elimination agrees to
rtol 1e-10 in f64 (inverted diagonal tiles included); the plain sweeps
agree with the JAX package's Pallas kernels run in interpret mode to 1e-12
in f64 and 1e-5 in f32 (f32 matvecs summed in another order). On the CPU
the wrappers run the plain versions. The CUDA kernel runs only on a card:
those tests are marked ``cuda`` and run with
``python -m pytest --noconftest -m cuda tests/test_torch_tri_stream.py``
(the suite's conftest imports jax, which the card's machine lacks).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch.ops import tri_stream as tts

torch.set_num_threads(1)

KERNEL_REL_TOL = 1e-5  # f32 products summed in another order than the plain version's


def _jax():
    jts = pytest.importorskip("cuadmm_tpu.ops.tri_stream")
    import jax.numpy as jnp

    return jts, jnp


def _random_aat(n, density=0.05, seed=1):
    """tests/test_tri_stream.py::_random_aat."""
    A = sp.random(n, 2 * n, density=density, random_state=seed, format="csr")
    return (A @ A.T).tocsr()


def _chain_aat(n, vec_len_per=6, coupling=30, seed=3):
    """AA^T of tests/test_tri_stream.py::_chain_A: banded, a trajectory's
    knot-point structure."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        for k in rng.choice(coupling + vec_len_per, size=4, replace=False):
            rows.append(i)
            cols.append(2 * i + int(k))
            vals.append(rng.standard_normal())
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n * 2 + coupling + vec_len_per))
    return (A @ A.T).tocsr()


def _bw(aat):
    coo = aat.tocoo()
    return int(np.abs(coo.row - coo.col).max())


@pytest.mark.parametrize("n,block", [(300, 64), (500, 128), (120, 128), (68350, 1024), (256, 128)])
def test_packed_layout_and_tables_match_jax(n, block):
    jts, _ = _jax()
    lay, jlay = tts.make_layout(n, block), jts.make_layout(n, block)
    assert tuple(lay) == tuple(jlay)
    for i in range(lay.nb):
        for j in range(i + 1):
            assert tts.tid(i, j) == jts.tid(i, j)
    for mine, theirs in zip(tts._fwd_meta(lay) + tts._bwd_meta(lay), jts._fwd_meta(jlay) + jts._bwd_meta(jlay)):
        assert mine.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize(
    "n,bw,block",
    [
        (500, 60, 64), (512, 128, 128), (300, 299, 64),
        (68350, 4, 0),  # the 20x120 grid max-cut under RCM
        (112028, 1615, 0),  # pendulum N=80 (cuadmm_tpu/ops/chol.py:104-109)
        (154256, 20512, 0),  # PushBox N=30
        (5000, 300, 0), (3000, 2999, 0),
    ],
)
def test_band_layout_block_model_and_tables_match_jax(n, bw, block):
    jts, _ = _jax()
    lay, jlay = tts.make_band_layout(n, bw, block), jts.make_band_layout(n, bw, block)
    assert tuple(lay) == tuple(jlay)
    for i in range(lay.nb):
        for j in range(max(0, i - lay.nbw), i + 1):
            assert tts.tid_band(i, j, lay) == jts.tid_band(i, j, jlay)
    for mine, theirs in zip(tts._fwd_band_meta(lay) + tts._bwd_band_meta(lay),
                            jts._fwd_band_meta(jlay) + jts._bwd_band_meta(jlay)):
        assert mine.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)


def test_grid_layouts_are_the_ones_auto_sees():
    """The 20x120 grid: band B 1024, nb 67, nbw 1 (134 slots, 0.56 GB f32);
    packed nb 67, T 2,278 (9.55 GB)."""
    band = tts.make_band_layout(68350, 4)
    assert (band.block, band.nb, band.nbw, band.T) == (1024, 67, 1, 134)
    packed = tts.make_layout(68350)
    assert (packed.nb, packed.T) == (67, 2278)


def _coo(aat):
    coo = aat.tocoo()
    return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data


@pytest.mark.parametrize("kind", ["packed", "band"])
def test_scatter_matches_jax(kind):
    jts, jnp = _jax()
    aat = _chain_aat(300)
    r, c, v = _coo(aat)
    dm = float(aat.diagonal().mean())
    if kind == "packed":
        lay = tts.make_layout(300, 64)
        mine = tts.scatter_packed_aat(r, c, v, lay, 1e-6, dm, torch.float64)
        theirs = jts.scatter_packed_aat(r, c, v, jts.make_layout(300, 64), 1e-6, dm, jnp.float64)
    else:
        lay = tts.make_band_layout(300, _bw(aat), 64)
        mine = tts.scatter_band_aat(r, c, v, lay, 1e-6, dm, torch.float64)
        theirs = jts.scatter_band_aat(r, c, v, jts.make_band_layout(300, _bw(aat), 64), 1e-6, dm, jnp.float64)
    assert mine.shape == (lay.T + 1, 64, 64) and mine.dtype == torch.float64
    np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_band_scatter_rejects_entries_outside_the_band():
    aat = _chain_aat(300)
    r, c, v = _coo(aat)
    lay = tts.make_band_layout(300, 1, 4)  # nbw 1; the pattern (bandwidth 17) reaches 4 blocks
    with pytest.raises(ValueError, match="outside"):
        tts.scatter_band_aat(r, c, v, lay, 1e-6, 1.0, torch.float64)


def _factored(kind, aat, n, block, eps, dtype):
    """Both packages' factors of one AA^T; the port's status as well."""
    jts, jnp = _jax()
    r, c, v = _coo(aat)
    dm = float(aat.diagonal().mean())
    jdt = {torch.float64: jnp.float64, torch.float32: jnp.float32}[dtype]
    if kind == "packed":
        lay, jlay = tts.make_layout(n, block), jts.make_layout(n, block)
        tiles = tts.scatter_packed_aat(r, c, v, lay, eps, dm, dtype)
        status = tts.packed_cholesky(tiles, lay)
        jtiles = jts.packed_cholesky(jts.scatter_packed_aat(r, c, v, jlay, eps, dm, jdt), jlay)
    else:
        bw = _bw(aat)
        lay, jlay = tts.make_band_layout(n, bw, block), jts.make_band_layout(n, bw, block)
        tiles = tts.scatter_band_aat(r, c, v, lay, eps, dm, dtype)
        status = tts.band_cholesky(tiles, lay)
        jtiles = jts.band_cholesky(jts.scatter_band_aat(r, c, v, jlay, eps, dm, jdt), jlay)
    return lay, tiles, status, np.array(jtiles)


@pytest.mark.parametrize("kind", ["packed", "band"])
@pytest.mark.parametrize("make", [_chain_aat, _random_aat], ids=["chain", "random_spd"])
def test_cholesky_matches_jax(kind, make):
    """n 500, B 64; tiles [0, T) (the JAX package's trailing tile is its
    sentinel), inverted diagonal tiles included, rtol 1e-10."""
    aat = make(500)
    lay, tiles, status, jtiles = _factored(kind, aat, 500, 64, 1e-6, torch.float64)
    assert int(status) == 0
    mine, theirs = tiles[: lay.T].numpy(), jtiles[: lay.T]
    assert np.linalg.norm(mine - theirs) / np.linalg.norm(theirs) < 1e-10
    diag = [tts.tid(k, k) if kind == "packed" else tts.tid_band(k, k, lay) for k in range(lay.nb)]
    np.testing.assert_allclose(mine[diag], theirs[diag], rtol=1e-10, atol=1e-10 * np.abs(theirs[diag]).max())
    # The inverted diagonal tiles times the factor's own diagonal blocks give I.
    dense = np.asarray(aat.todense()) + 1e-6 * max(aat.diagonal().mean(), 1.0) * np.eye(500)
    L = np.linalg.cholesky(dense)
    for k in range(lay.nb - 1):  # full blocks
        blk = L[k * 64 : (k + 1) * 64, k * 64 : (k + 1) * 64]
        np.testing.assert_allclose(mine[diag[k]] @ blk, np.eye(64), atol=1e-9)


@pytest.mark.parametrize("kind", ["packed", "band"])
def test_indefinite_leading_tile_is_reported(kind):
    """An indefinite leading diagonal tile: cholesky_ex's partial factor is
    not NaN, so the status is what reports the failed factor."""
    n, B = 256, 64
    lay = tts.make_layout(n, B) if kind == "packed" else tts.make_band_layout(n, 64, B)
    rng = np.random.default_rng(4)
    a = rng.standard_normal((n, n))
    p = a @ a.T + n * np.eye(n)
    p[:B, :B] -= 3 * n * np.eye(B)  # the leading tile turns indefinite
    pc = sp.coo_matrix(np.tril(p) if kind == "packed" else np.tril(np.triu(p, -B)))
    r, c, v = pc.row.astype(np.int64), pc.col.astype(np.int64), pc.data
    if kind == "packed":
        tiles = tts.scatter_packed_aat(r, c, v, lay, 0.0, 1.0, torch.float64)
        status = tts.packed_cholesky(tiles, lay)
    else:
        tiles = tts.scatter_band_aat(r, c, v, lay, 0.0, 1.0, torch.float64)
        status = tts.band_cholesky(tiles, lay)
    assert int(status) != 0


def _solve_case(kind, dtype, n=300, block=64):
    aat = _chain_aat(n)
    lay, tiles, status, jtiles = _factored(kind, aat, n, block, 1e-6, dtype)
    assert int(status) == 0
    r = np.random.default_rng(0).standard_normal(n)
    return lay, tiles, jtiles, r, aat


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["packed", "band"])
def test_plain_solve_matches_pallas_interpret(kind, dtype, tol):
    """Both sweeps on the same tiles (the JAX package's factor)."""
    jts, jnp = _jax()
    lay, _, jtiles, r, _ = _solve_case(kind, dtype)
    tiles = torch.as_tensor(jtiles)
    rt = torch.as_tensor(r).to(dtype)
    if kind == "packed":
        mine = tts.packed_solve_ref(tiles, rt, lay).numpy()
        theirs = np.asarray(jts.packed_solve(jnp.asarray(jtiles), jnp.asarray(rt.numpy()),
                                             jts.PackedLayout(*lay), interpret=True))
    else:
        mine = tts.band_solve_ref(tiles, rt, lay).numpy()
        theirs = np.asarray(jts.band_solve(jnp.asarray(jtiles), jnp.asarray(rt.numpy()),
                                           jts.BandLayout(*lay), interpret=True))
    assert mine.dtype == theirs.dtype
    assert np.linalg.norm(mine - theirs) / np.linalg.norm(theirs) < tol


@pytest.mark.parametrize("kind", ["packed", "band"])
def test_plain_solve_inverts_the_regularized_aat(kind):
    lay, tiles, _, r, aat = _solve_case(kind, torch.float64)
    solve = tts.packed_solve_ref if kind == "packed" else tts.band_solve_ref
    y = solve(tiles, torch.as_tensor(r), lay).numpy()
    dense = np.asarray(aat.todense()) + 1e-6 * max(aat.diagonal().mean(), 1.0) * np.eye(len(r))
    ref = np.linalg.solve(dense, r)
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-9


@pytest.mark.parametrize("kind", ["packed", "band"])
def test_cpu_tensors_run_the_plain_version_and_launch_nothing(kind):
    lay, tiles, _, r, _ = _solve_case(kind, torch.float64)
    wrapper, ref = ((tts.packed_solve, tts.packed_solve_ref) if kind == "packed"
                    else (tts.band_solve, tts.band_solve_ref))
    before = dict(tts.LAUNCHES)
    rt = torch.as_tensor(r)
    torch.testing.assert_close(wrapper(tiles, rt, lay), ref(tiles, rt, lay), rtol=0, atol=0)
    assert tts.LAUNCHES == before


def test_kernel_step_tables_cover_every_tile_once():
    """The kernel's step tables: each sweep visits every tile of the layout
    once, each step ends on the diagonal tile of the block it solves."""
    for lay in (tts.make_layout(700, 128), tts.make_band_layout(700, 200, 128)):
        for table, transpose in zip(tts._sweep_tables(lay), (False, True)):
            st = tts._steps(table, transpose)
            seen = np.sort(np.r_[st["off_tile"], st["diag_tile"]])
            np.testing.assert_array_equal(seen, np.sort(table[0]))
            assert len(st["step_blk"]) == lay.nb
            order = st["step_blk"] if not transpose else st["step_blk"][::-1]
            np.testing.assert_array_equal(order, np.arange(lay.nb))
            tid = tts.tid if isinstance(lay, tts.PackedLayout) else (lambda i, j: tts.tid_band(i, j, lay))
            np.testing.assert_array_equal(st["diag_tile"], [tid(b, b) for b in st["step_blk"]])
            assert len(st["off_tile"]) == len(st["off_blk"]) == st["off_start"][-1]


@pytest.mark.parametrize(
    "tiles,r,err",
    [
        (torch.zeros(3, 64, 64), torch.zeros(200), ValueError),  # too few tiles for T = 6
        (torch.zeros(7, 64, 32), torch.zeros(200), ValueError),  # tile shape
        (torch.zeros(7, 64, 64), torch.zeros(300), ValueError),  # r past n_pad
        (torch.zeros(7, 64, 64), torch.zeros(2, 100), ValueError),  # r not 1-D
        (torch.empty(7, 64, 64, device="meta"), torch.zeros(200), ValueError),  # devices differ
        (torch.empty(7, 64, 64, device="meta"), torch.empty(200, device="meta"), ValueError),
    ],
    ids=["few_tiles", "tile_shape", "r_long", "r_2d", "mixed_devices", "meta_device"],
)
def test_wrapper_rejects(tiles, r, err):
    lay = tts.make_layout(200, 64)
    before = dict(tts.LAUNCHES)
    with pytest.raises(err):
        tts.packed_solve(tiles, r, lay)
    assert tts.LAUNCHES == before


def _synthetic_factor(lay, seed, device):
    """Well-conditioned synthetic factor: diagonal tiles near the identity,
    off-diagonal tiles scaled by 1/sqrt(B * nbw)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B = lay.block
    nbw = getattr(lay, "nbw", lay.nb - 1)
    tiles = torch.randn((lay.T + 1, B, B), generator=gen, device=device) / (B * max(nbw, 1)) ** 0.5
    diag = [tts.tid(k, k) if isinstance(lay, tts.PackedLayout) else tts.tid_band(k, k, lay) for k in range(lay.nb)]
    eye = torch.eye(B, device=device)
    tiles[diag] = eye + 0.1 * tiles[diag]
    return tiles


@pytest.mark.cuda
@pytest.mark.parametrize(
    "lay",
    [tts.make_layout(256, 128), tts.make_layout(3000, 1024), tts.make_band_layout(512, 128, 128),
     tts.make_band_layout(5000, 1500, 1024), tts.make_band_layout(4000, 300, 256)],
    ids=["packed_probe", "packed_b1024", "band_probe", "band_b1024", "band_b256"],
)
def test_kernel_matches_plain_on_card(lay):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    tiles = _synthetic_factor(lay, 7, "cuda")
    r = torch.randn(lay.n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(8))
    packed = isinstance(lay, tts.PackedLayout)
    wrapper, ref = (tts.packed_solve, tts.packed_solve_ref) if packed else (tts.band_solve, tts.band_solve_ref)
    name = "packed_solve" if packed else "band_solve"
    before = tts.LAUNCHES[name]
    y = wrapper(tiles, r, lay)
    torch.cuda.synchronize()
    assert tts.LAUNCHES[name] == before + 1
    plain = ref(tiles.double(), r.double(), lay)
    assert float(torch.linalg.norm(y.double() - plain) / torch.linalg.norm(plain)) < KERNEL_REL_TOL
    # Deterministic: partials are summed in the tables' fixed order.
    assert torch.equal(wrapper(tiles, r, lay), y)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lay = tts.make_layout(200, 64)  # B 64: below the kernel's 128
    with pytest.raises(ValueError, match="block"):
        tts.packed_solve(torch.zeros(lay.T + 1, 64, 64, device="cuda"), torch.zeros(200, device="cuda"), lay)
    lay = tts.make_layout(256, 128)
    with pytest.raises(TypeError):
        tts.packed_solve(torch.zeros(lay.T + 1, 128, 128, device="cuda", dtype=torch.float64),
                         torch.zeros(256, device="cuda"), lay)
