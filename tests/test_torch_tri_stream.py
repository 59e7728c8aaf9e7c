"""The packed and banded factor (K2, K3) against cuadmm_tpu.ops.tri_stream.

Layouts, meta tables and scatters agree exactly; the elimination agrees to
rtol 1e-10 in f64 (inverted diagonal tiles included); the plain sweeps
agree with the JAX package's Pallas kernels run in interpret mode to 1e-12
in f64 and 1e-5 in f32 (f32 matvecs summed in another order), and so does
a plain walk of the one-hop form's tables over its derived tiles (W, Ut).
On the CPU the wrappers run the plain versions. The CUDA kernel runs only on a card:
those tests are marked ``cuda`` and run with
``python -m pytest --noconftest -m cuda tests/test_torch_tri_stream.py``
(the suite's conftest imports jax, which the card's machine lacks).
"""

import ctypes
import dataclasses
import os
import re
import tempfile

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch.ops import tri_stream as tts
from cuadmm_tpu_torch.trace import COUNTS

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


def _chain_a(n, vec_len_per=6, coupling=30, seed=3):
    """tests/test_tri_stream.py::_chain_A: a trajectory's knot-point
    structure, whose AA^T is banded."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        for k in rng.choice(coupling + vec_len_per, size=4, replace=False):
            rows.append(i)
            cols.append(2 * i + int(k))
            vals.append(rng.standard_normal())
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n * 2 + coupling + vec_len_per))


def _chain_aat(n, vec_len_per=6, coupling=30, seed=3):
    """AA^T of tests/test_tri_stream.py::_chain_A."""
    A = _chain_a(n, vec_len_per, coupling, seed)
    return (A @ A.T).tocsr()


# The JAX package's block model (cuadmm_tpu/ops/tri_stream.py:463-478): tile
# bytes at 800 GB/s plus 3 us a tile step, a TPU's.
JAX_BAND_MODEL = lambda T, B, nb: T * B * B * 4 / 800e9 + T * 3e-6


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
    """Given the JAX package's block model, the port picks its block; the
    layout's tables agree."""
    jts, _ = _jax()
    lay, jlay = tts.make_band_layout(n, bw, block, model=JAX_BAND_MODEL), jts.make_band_layout(n, bw, block)
    assert tuple(lay) == tuple(jlay)
    for i in range(lay.nb):
        for j in range(max(0, i - lay.nbw), i + 1):
            assert tts.tid_band(i, j, lay) == jts.tid_band(i, j, jlay)
    for mine, theirs in zip(tts._fwd_band_meta(lay) + tts._bwd_band_meta(lay),
                            jts._fwd_band_meta(jlay) + jts._bwd_band_meta(jlay)):
        assert mine.dtype == np.int32
        np.testing.assert_array_equal(mine, theirs)


def test_grid_layouts_are_the_ones_auto_sees():
    """The 20x120 grid: band B 512, nb 134, nbw 1 (268 slots, 0.28 GB f32,
    as much again in derived tiles) under the card's model (the default),
    where K3's one-hop form runs B 512 fastest; B 1024, nb 67 (134 slots,
    0.56 GB) under the JAX package's; the 20x80 grid's band B 512 under
    the card's (nb 87), 1024 under the JAX package's; packed nb 67, T 2,278
    (9.55 GB)."""
    from cuadmm_tpu_torch.ops.limits import BAND_MODEL

    for model in (None, BAND_MODEL):
        band = tts.make_band_layout(68350, 4, model=model)
        assert (band.block, band.nb, band.nbw, band.T) == (512, 134, 1, 268)
    band = tts.make_band_layout(68350, 4, model=JAX_BAND_MODEL)
    assert (band.block, band.nb, band.nbw, band.T) == (1024, 67, 1, 134)
    assert tts.make_band_layout(44312, 4)[2:5] == (512, 87, 1)
    assert tts.make_band_layout(44312, 4, model=JAX_BAND_MODEL)[2:5] == (1024, 44, 1)
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
    before = dict(COUNTS)
    rt = torch.as_tensor(r)
    torch.testing.assert_close(wrapper(tiles, rt, lay), ref(tiles, rt, lay), rtol=0, atol=0)
    assert COUNTS == before


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


WORK_LAYOUTS = [
    tts.make_layout(256, 128), tts.make_band_layout(512, 128, 128),  # the probes
    tts.make_layout(1342, 256), tts.make_band_layout(1342, 4, 512),  # the 8x12 grid's (test_torch_solver.py)
    tts.make_band_layout(4000, 300, 256),  # nbw 2
]
WORK_IDS = ["packed_probe", "band_probe", "packed_grid8x12", "band_grid8x12", "band_nbw2"]


@pytest.mark.parametrize("lay", WORK_LAYOUTS, ids=WORK_IDS)
def test_work_tables_cover_every_tile_once_and_wait_backwards(lay):
    """The persistent kernel's work tables: per sweep every tile's B/8 slabs
    appear once; items come in step order, an off-diagonal item reads a
    block an earlier step solved, and a step's diagonal items (its diagonal
    tile) follow all its off-diagonal ones."""
    B, slabs = lay.block, lay.block // tts.SLAB
    for table, transpose in zip(tts._sweep_tables(lay), (False, True)):
        st = tts._steps(table, transpose)
        items, steps, row_blk = tts._work_table(st, B)
        tile, step, slab, prow = items.T
        assert items.dtype == steps.dtype == row_blk.dtype == np.int32
        assert np.all(np.diff(step) >= 0)
        pairs = sorted(zip(tile.tolist(), slab.tolist()))
        assert pairs == sorted((t, e) for t in table[0].tolist() for e in range(slabs))
        solved_at = {int(b): s for s, b in enumerate(steps[:, 0])}
        off = prow >= 0
        assert all(solved_at[b] < s for b, s in zip(row_blk[prow[off]], step[off]))
        for s, (blk, p0, np_) in enumerate(steps):
            mine = np.flatnonzero(step == s)
            is_off = off[mine]
            assert is_off.sum() == np_ * slabs and (~is_off).sum() == slabs
            assert np.all(is_off[: np_ * slabs]) and not np.any(is_off[np_ * slabs :])
            assert sorted(set(prow[mine[is_off]])) == list(range(p0, p0 + np_))
            assert blk == st["step_blk"][s] and np.all(tile[mine[~is_off]] == st["diag_tile"][s])


def _walk_items(tiles, rhs, table, transpose):
    """The kernel's arithmetic in plain torch: the work items in table order,
    each slab's product into its partial row or its 8 outputs."""
    B = tiles.shape[-1]
    items, steps, row_blk = tts._work_table(tts._steps(table, transpose), B)
    out = torch.zeros_like(rhs)
    partial = torch.zeros(max(len(row_blk), 1), B, dtype=rhs.dtype)
    for tile, step, e, prow in items.tolist():
        t = tiles[tile].mT if transpose else tiles[tile]
        rows = slice(e * tts.SLAB, (e + 1) * tts.SLAB)
        if prow >= 0:
            rd = int(row_blk[prow])
            partial[prow, rows] = t[rows] @ out[rd * B : (rd + 1) * B]
        else:
            blk, p0, np_ = steps[step].tolist()
            acc = rhs[blk * B : (blk + 1) * B].clone()
            for p in range(p0, p0 + np_):
                acc -= partial[p]
            out[blk * B + e * tts.SLAB : blk * B + (e + 1) * tts.SLAB] = t[rows] @ acc
    return out


@pytest.mark.parametrize("lay", WORK_LAYOUTS[:4], ids=WORK_IDS[:4])
def test_work_table_walk_matches_plain(lay):
    """Walking both sweeps' items in table order solves what the plain
    versions solve (f64, rtol 1e-12)."""
    tiles = _synthetic_factor(lay, 3, "cpu").double()
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(lay.n))
    fwd, bwd = tts._sweep_tables(lay)
    rp = torch.nn.functional.pad(r, (0, lay.n_pad - lay.n))
    y = _walk_items(tiles, _walk_items(tiles, rp, fwd, False), bwd, True)[: lay.n]
    ref = (tts.packed_solve_ref if isinstance(lay, tts.PackedLayout) else tts.band_solve_ref)(tiles, r, lay)
    assert float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref)) < 1e-12


CHAIN_LAYOUTS = [tts.make_band_layout(512, 128, 128), tts.make_band_layout(1342, 4, 512),
                 tts.make_band_layout(1000, 200, 128), tts.make_band_layout(640, 100, 128),
                 tts.make_band_layout(1200, 500, 128)]
CHAIN_IDS = ["nbw1_probe", "nbw1_grid8x12", "nbw2", "nbw1_b128", "nbw4"]


def test_chain_form_is_taken_at_narrow_bands_only():
    """NBW_CHAIN (4) splits the forms: the grid's band (nbw 1), pendulum's
    at B 1024 and 512 (nbw 2, 4) take the one-hop form; the mid band at B
    1024 (nbw 5) and PushBox's (nbw 21) keep the two-hop form; band_bytes
    counts the derived tiles (2 nb nbw) only in the one-hop form."""
    assert tts.NBW_CHAIN == 4
    grid, pend, pend512, mid, push = (
        tts.make_band_layout(68350, 4, 1024), tts.make_band_layout(112028, 1615, 1024),
        tts.make_band_layout(112028, 1615, 512), tts.make_band_layout(100000, 5000, 1024),
        tts.make_band_layout(154256, 20512, 1024))
    assert (grid.nbw, pend.nbw, pend512.nbw, mid.nbw, push.nbw) == (1, 2, 4, 5, 21)
    assert all(tts.band_form(lay) == "chain" for lay in (grid, pend, pend512))
    assert tts.band_form(mid) == tts.band_form(push) == "two_hop"
    assert tts.band_bytes(grid, "chain") == (134 + 134) * 1024**2 * 4  # 0.56 -> 1.12 GB
    assert tts.band_bytes(grid, "two_hop") == 134 * 1024**2 * 4
    assert tts.band_bytes(push, "two_hop") == push.T * 1024**2 * 4


def test_a_narrow_band_whose_derived_tiles_do_not_fit_runs_two_hop():
    """A card whose band ceiling lies between a narrow band's bytes and its
    bytes with the derived tiles still places it (auto picks banded, as
    the parent rule did on the band alone) and runs it in the two-hop
    form: band_form, the build (no derived tiles, form two_hop, a solve
    equal to the one-hop build's on the CPU) and K3's model (the two-hop terms at that
    block) all read the one ceiling."""
    from cuadmm_tpu_torch.ops import chol as tchol
    from cuadmm_tpu_torch.ops import limits as lim
    from cuadmm_tpu_torch.ops import sparse as tsparse
    from cuadmm_tpu_torch.structure import BlockStructure

    grid = tts.make_band_layout(68350, 4, 1024)  # 0.56 GB, 1.12 GB with the derived tiles
    between = (tts.band_bytes(grid, "two_hop") + tts.band_bytes(grid, "chain")) // 2
    assert tts.band_form(grid, between) == "two_hop" and tts.band_form(grid, 2 * between) == "chain"
    assert lim.band_form(grid.T, grid.block, grid.nb, between) == "two_hop"
    card = lim.limits_for(40 * 10**9)
    low = dataclasses.replace(card, band_max_bytes=between, packed_max_con=0)
    assert tchol.past_ceiling_mode(68350, 4, True, 1, low) == "banded"
    two_hop = dataclasses.replace(lim.BAND_MODEL, one_hop=None)
    for B in (1024, 512, 256):
        lay = tts.make_band_layout(68350, 4, B)
        want = (lim.BAND_MODEL.one_hop if tts.band_form(lay, between) == "chain" else two_hop)(lay.T, B, lay.nb)
        assert low.bound_band_model()(lay.T, B, lay.nb) == want
    assert tts.band_form(tts.make_band_layout(68350, 4, 512), between) == "chain"  # 0.56 GB held at B 512

    A = _chain_a(2500)  # nb 3, nbw 1 at B 1024
    con, vec_len = A.shape
    coo = A.tocoo()
    args = (coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data, con, vec_len)
    sa = tsparse.build_sparse_a_pool(*args[:4], BlockStructure([("u", vec_len)], "pow2", 64, 0),
                                     torch.float64, torch.device("cpu"))
    lay = tts.make_band_layout(con, 1, 1024)
    fits = tts.band_bytes(lay, "two_hop")
    small = dataclasses.replace(card, band_max_bytes=fits, band_model=lambda T, B, nb: -B)  # B 1024
    neq = tchol.build_normal_solver(*args, sa, "banded", torch.float64, torch.device("cpu"), applies=2,
                                    limits=small)
    assert neq.factor.layout == lay and lay.nbw == 1
    assert neq.factor.form == "two_hop" and neq.factor.chain is None
    full = tchol.build_normal_solver(*args, sa, "banded", torch.float64, torch.device("cpu"), applies=2,
                                     limits=dataclasses.replace(small, band_max_bytes=tts.band_bytes(lay, "chain")))
    assert full.factor.form == "chain" and full.factor.chain is not None
    torch.testing.assert_close(neq.factor.tiles, full.factor.tiles, rtol=0, atol=0)
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(lay.n_pad), dtype=torch.float32)
    y = neq.factor.apply(r)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, full.factor.apply(r), rtol=0, atol=0)


@pytest.mark.parametrize("lay", CHAIN_LAYOUTS[:3], ids=CHAIN_IDS[:3])
def test_band_chain_matches_numpy_products(lay):
    """W_ij = inv(L_ii) L_ij and Ut_ji = inv(L_jj)^T L_ij^T from seeded f32
    tiles, against numpy's f64 products rounded to f32 (the same rounding:
    equal to 1 ulp); unused corner slots are zero."""
    rng = np.random.default_rng(5)
    tiles_np = rng.standard_normal((lay.T + 1, lay.block, lay.block)).astype(np.float32)
    chain = tts.band_chain(torch.as_tensor(tiles_np), lay).numpy()
    half = lay.nb * lay.nbw
    assert chain.shape == (2 * half, lay.block, lay.block) and chain.dtype == np.float32
    seen = set()
    for i in range(lay.nb):
        for j in range(max(0, i - lay.nbw), i):
            l_ij = tiles_np[tts.tid_band(i, j, lay)].astype(np.float64)
            inv_i = tiles_np[tts.tid_band(i, i, lay)].astype(np.float64)
            inv_j = tiles_np[tts.tid_band(j, j, lay)].astype(np.float64)
            k = tts.chain_slot(i, j, lay)
            seen.add(k)
            np.testing.assert_allclose(chain[k], (inv_i @ l_ij).astype(np.float32), rtol=2e-6, atol=1e-5)
            np.testing.assert_allclose(chain[half + k], (inv_j.T @ l_ij.T).astype(np.float32), rtol=2e-6, atol=1e-5)
    unused = sorted(set(range(half)) - seen)
    assert len(unused) == lay.nbw * (lay.nbw + 1) // 2
    assert not chain[unused].any() and not chain[[half + k for k in unused]].any()


@pytest.mark.parametrize("lay", CHAIN_LAYOUTS, ids=CHAIN_IDS)
def test_chain_tables_cover_every_tile_once_and_wait_backwards(lay):
    """The one-hop tables: per sweep every band tile is read once (the
    diagonal tiles from the band, the off-diagonal ones as their W or Ut);
    steps come in sweep order; a step's entries read blocks solved at
    earlier steps, within the band, the newest last. Items (step s, slab e)
    are numbered s B/16 + e, so every item an item waits for comes earlier
    in the table."""
    half = lay.nb * lay.nbw
    off_slot = {tts.chain_slot(i, j, lay): tts.tid_band(i, j, lay)
                for i in range(lay.nb) for j in range(max(0, i - lay.nbw), i)}
    for sw, transpose in zip(tts._chain_tables(lay), (False, True)):
        steps, offs = sw["steps"], sw["offs"]
        assert steps.dtype == offs.dtype == np.int32 and steps.shape == (lay.nb, 4)
        order = np.arange(lay.nb)[::-1] if transpose else np.arange(lay.nb)
        np.testing.assert_array_equal(steps[:, 0], order)
        np.testing.assert_array_equal(steps[:, 1], [tts.tid_band(b, b, lay) for b in order])
        solved_at = {int(b): s for s, b in enumerate(steps[:, 0])}
        read = list(steps[:, 1])
        for s, (blk, _, first, count) in enumerate(steps):
            entries = offs[first : first + count]
            if s + 1 < lay.nb:
                assert first + count == steps[s + 1, 2]
            blocks = [int(b) for _, b in entries]
            assert all(solved_at[b] < s and 0 < abs(b - blk) <= lay.nbw for b in blocks)
            assert count == len(set(blocks)) == min(lay.nbw, blk if not transpose else lay.nb - 1 - blk)
            if count:
                assert solved_at[blocks[-1]] == s - 1  # the newest block, on the chain, last
            for k, b in entries:
                assert (k >= half) == transpose
                i, j = (b, blk) if transpose else (blk, b)
                assert off_slot[int(k) - half * transpose] == tts.tid_band(i, j, lay)
                read.append(off_slot[int(k) - half * transpose])
        assert sorted(read) == sorted(tts._sweep_tables(lay)[1 if transpose else 0][0].tolist())


def _walk_chain(tiles, chain, rhs, sw, transpose, slab=16):
    """The one-hop kernel's arithmetic in plain torch: items in table order,
    each slab's diagonal product first, then its chain products subtracted
    in table order."""
    B = tiles.shape[-1]
    out = torch.zeros_like(rhs)
    for blk, diag, first, count in sw["steps"].tolist():
        for e in range(0, B, slab):
            rows = slice(e, e + slab)
            d = tiles[diag].mT if transpose else tiles[diag]
            acc = d[rows] @ rhs[blk * B : (blk + 1) * B]
            for k, b in sw["offs"][first : first + count].tolist():
                acc = acc - chain[k][rows] @ out[b * B : (b + 1) * B]
            out[blk * B + e : blk * B + e + slab] = acc
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)], ids=["f64", "f32"])
@pytest.mark.parametrize("lay", [CHAIN_LAYOUTS[0], CHAIN_LAYOUTS[2], CHAIN_LAYOUTS[4]], ids=["nbw1", "nbw2", "nbw4"])
def test_chain_walk_matches_plain_and_pallas_interpret(lay, dtype, tol):
    """Both one-hop sweeps walked over band_chain's tiles solve what
    band_solve_ref and the JAX package's band_solve (interpret mode) solve
    on the same tiles: 1e-12 in f64, 1e-5 in f32 (products in another order,
    W and Ut rounded once)."""
    jts, jnp = _jax()
    tiles = _synthetic_factor(lay, 3, "cpu").to(dtype)
    chain = tts.band_chain(tiles, lay)
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(lay.n)).to(dtype)
    fwd, bwd = tts._chain_tables(lay)
    rp = torch.nn.functional.pad(r, (0, lay.n_pad - lay.n))
    y = _walk_chain(tiles, chain, _walk_chain(tiles, chain, rp, fwd, False), bwd, True)[: lay.n].double()
    ref = tts.band_solve_ref(tiles, r, lay).double()
    theirs = torch.as_tensor(np.array(jts.band_solve(jnp.asarray(tiles.numpy()), jnp.asarray(r.numpy()),
                                                       jts.BandLayout(*lay), interpret=True))).double()
    for other in (ref, theirs):
        assert float(torch.linalg.norm(y - other) / torch.linalg.norm(other)) < tol


def test_banded_solvers_from_the_build_and_convert_carry_chain_tiles():
    """A banded NormalEqSolver built by the port and one carried over from
    the JAX package's build (convert.py) each hold band_chain of its own
    tiles; the two agree as their f32 factors do; a band wider than
    NBW_CHAIN carries none. The solve on the CPU reads the tiles alone."""
    from cuadmm_tpu.ops import chol as jchol
    from cuadmm_tpu.ops import sparse as jsparse

    from cuadmm_tpu_torch import convert
    from cuadmm_tpu_torch.ops import chol as tchol
    from cuadmm_tpu_torch.ops import sparse as tsparse
    from cuadmm_tpu_torch.structure import BlockStructure

    _, jnp = _jax()
    A = _chain_a(2500)  # B 1024 under both packages' models: nb 3, nbw 1
    con, vec_len = A.shape
    coo = A.tocoo()
    args = (coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data, con, vec_len)
    sa_t = tsparse.build_sparse_a_pool(*args[:4], BlockStructure([("u", vec_len)], "pow2", 64, 0),
                                       torch.float64, torch.device("cpu"))
    neq_t = tchol.build_normal_solver(*args, sa_t, "banded", torch.float64, torch.device("cpu"), applies=2)
    neq_j = jchol.build_normal_solver(*args, jsparse.build_sparse_a(*args, jnp.float64), "banded", jnp.float64,
                                      applies=2)
    neq_c = convert.normal_solver_from_numpy(neq_j, torch.device("cpu"))
    lay = neq_t.factor.layout
    assert neq_c.factor.layout == lay and lay.nb > 1 and 0 < lay.nbw <= tts.NBW_CHAIN
    for neq in (neq_t, neq_c):
        assert neq.factor.form == "chain"
        assert neq.factor.chain is not None and neq.factor.chain.dtype == torch.float32
        torch.testing.assert_close(neq.factor.chain, tts.band_chain(neq.factor.tiles, lay), rtol=0, atol=0)
    used = [k for i in range(lay.nb) for j in range(max(0, i - lay.nbw), i)
            for k in (tts.chain_slot(i, j, lay), lay.nb * lay.nbw + tts.chain_slot(i, j, lay))]
    rel = lambda a, b: float(torch.linalg.norm(a.double() - b.double()) / torch.linalg.norm(b.double()))
    tiles_rel = rel(neq_t.factor.tiles[: lay.T], neq_c.factor.tiles[: lay.T])  # the JAX package's CPU factor is f64
    assert rel(neq_t.factor.chain[used], neq_c.factor.chain[used]) <= 2 * tiles_rel + 1e-6
    wide = tts.make_band_layout(1000, 900, 128)  # nbw 7
    assert wide.nbw > tts.NBW_CHAIN and tchol.chain_tiles(torch.zeros(wide.T + 1, 128, 128), wide) == ("two_hop", None)


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
    before = dict(COUNTS)
    with pytest.raises(err):
        tts.packed_solve(tiles, r, lay)
    assert COUNTS == before


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


def _band_chain(tiles, lay):
    """band_solve's derived tiles where the layout takes the one-hop form."""
    return tts.band_chain(tiles, lay) if tts.band_form(lay) == "chain" else None


def _kernel_for(lay, tiles):
    """The wrapper as the solver calls it, and its plain version."""
    if isinstance(lay, tts.PackedLayout):
        return (lambda r: tts.packed_solve(tiles, r, lay)), tts.packed_solve_ref, "packed_solve"
    chain = _band_chain(tiles, lay)
    return (lambda r: tts.band_solve(tiles, r, lay, chain=chain)), tts.band_solve_ref, "band_solve"


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
    solve, ref, name = _kernel_for(lay, tiles)
    before = COUNTS[tts.COUNTER[name]]
    y = solve(r)
    torch.cuda.synchronize()
    assert COUNTS[tts.COUNTER[name]] == before + 1
    plain = ref(tiles.double(), r.double(), lay)
    assert float(torch.linalg.norm(y.double() - plain) / torch.linalg.norm(plain)) < KERNEL_REL_TOL
    # Deterministic: partials are summed in the tables' fixed order.
    assert torch.equal(solve(r), y)


# Both forms at nbw 1 and 2 and at each block the band model picks from, and
# at nbw 4 (NBW_CHAIN); the two-hop form also at nbw 5, past it.
FORM_LAYOUTS = [(tts.make_band_layout(n, bw, B), form) for B in (256, 512, 1024)
                for n, bw in ((6 * B + 77, 3), (6 * B + 77, B + 5)) for form in ("chain", "two_hop")]
FORM_LAYOUTS += [(tts.make_band_layout(8 * 512 + 77, 3 * 512 + 5, 512), form) for form in ("chain", "two_hop")]
FORM_LAYOUTS += [(tts.make_band_layout(8 * 512 + 77, 4 * 512 + 5, 512), "two_hop")]


@pytest.mark.cuda
@pytest.mark.parametrize("lay,form", FORM_LAYOUTS,
                         ids=[f"B{lay.block}_nbw{lay.nbw}_{form}" for lay, form in FORM_LAYOUTS])
def test_band_forms_match_plain_and_repeat_bitwise_on_card(lay, form):
    """Each form of K3 against band_solve_ref in f64, within
    KERNEL_REL_TOL; two solves of one r bitwise equal; one count and two
    sweep launches (a captured graph's kernel nodes) a solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    tiles = _synthetic_factor(lay, 11, "cuda")
    chain = tts.band_chain(tiles, lay) if form == "chain" else None
    r = torch.randn(lay.n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(12))
    solve = lambda: tts.band_solve(tiles, r, lay, chain=chain, form=form)
    before = COUNTS["k3"]
    y = solve()
    torch.cuda.synchronize()
    assert COUNTS["k3"] == before + 1
    plain = tts.band_solve_ref(tiles.double(), r.double(), lay)
    assert float(torch.linalg.norm(y.double() - plain) / torch.linalg.norm(plain)) < KERNEL_REL_TOL
    assert torch.equal(solve(), y)
    assert _sweeps_per_solve(solve) == 2


SWEEP_KERNELS = ("tri_sweep_kernel", "chain_sweep_kernel")  # the two-hop and one-hop sweeps


def _sweeps_per_solve(solve) -> int:
    """Sweep kernels one ``solve()`` launches: the kernel nodes of a CUDA
    graph that captures it, named in the driver's DOT print of the graph
    (``cuGraphDebugDotPrint``). A graph holds every launch of the capture,
    where a profiler trace can drop an event. ``solve`` has run before, so
    its tables and plans are built outside the capture."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        solve()
    driver = ctypes.CDLL("libcuda.so.1")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "solve.dot")
        err = driver.cuGraphDebugDotPrint(ctypes.c_void_p(graph.raw_cuda_graph()), path.encode(), ctypes.c_uint(0))
        assert err == 0, f"cuGraphDebugDotPrint failed: CUresult {err}"
        with open(path) as f:
            text = f.read()
    del graph
    nodes = re.split(r'"graph_\d+_node_\d+"\s*\[', text)[1:]  # one chunk a node definition
    return sum(any(k in node for k in SWEEP_KERNELS) for node in nodes)


@pytest.mark.cuda
def test_chain_form_without_its_tiles_raises_on_card():
    """A layout that takes the one-hop form never drops back to the
    two-hop form: without its derived tiles the wrapper raises and
    launches nothing; derived tiles of the wrong shape raise too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lay = tts.make_band_layout(512, 128, 128)
    tiles = _synthetic_factor(lay, 7, "cuda")
    r = torch.randn(lay.n, device="cuda")
    before = COUNTS["k3"]
    with pytest.raises(ValueError, match="one-hop"):
        tts.band_solve(tiles, r, lay)
    with pytest.raises(ValueError, match="chain tiles"):
        tts.band_solve(tiles, r, lay, chain=tts.band_chain(tiles, lay)[1:])
    assert COUNTS["k3"] == before


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


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["chain", "two_hop"])
def test_kernel_grid_past_co_residency_raises_on_card(monkeypatch, form):
    """A grid larger than the card can hold at once fails the cooperative
    launch (it would hang a persistent sweep); the wrapper raises, and the
    next solve, on a new epoch, is right again. Both forms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lay = tts.make_band_layout(512, 128, 128) if form == "chain" else tts.make_band_layout(1024, 700, 128)
    tiles = _synthetic_factor(lay, 7, "cuda")
    chain = _band_chain(tiles, lay)
    r = torch.randn(lay.n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(8))
    y = tts.band_solve(tiles, r, lay, chain=chain)
    if form == "chain":
        key = (None, torch.cuda.current_device(), lay.block)
        stages, ctas = tts._PLANS[key]
        monkeypatch.setitem(tts._PLANS, key, (stages, 2 * ctas))
    else:
        key = (None, torch.cuda.current_device(), lay.block)
        monkeypatch.setitem(tts._CTAS, key, 2 * tts._CTAS[key])
    before = COUNTS["k3"]
    with pytest.raises(RuntimeError, match="launch"):
        tts.band_solve(tiles, r, lay, chain=chain)
    assert COUNTS["k3"] == before
    monkeypatch.undo()
    assert torch.equal(tts.band_solve(tiles, r, lay, chain=chain), y)


@pytest.mark.cuda
def test_kernel_is_two_launches_per_solve_on_card():
    """One persistent launch per sweep, counted in a captured graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lay = tts.make_band_layout(5000, 1500, 1024)
    tiles = _synthetic_factor(lay, 7, "cuda")
    chain = _band_chain(tiles, lay)
    r = torch.randn(lay.n, device="cuda")
    tts.band_solve(tiles, r, lay, chain=chain)
    torch.cuda.synchronize()
    assert _sweeps_per_solve(lambda: tts.band_solve(tiles, r, lay, chain=chain)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("lay", [tts.make_layout(3000, 1024), tts.make_band_layout(5000, 1500, 1024),
                                 tts.make_band_layout(5000, 2600, 512)],
                         ids=["packed", "band", "band_two_hop"])
def test_captured_solve_replays_on_a_new_epoch_on_card(lay):
    """A solve captured into a CUDA graph and replayed 3 times in a row,
    each with a new right-hand side copied in: every replay equals an eager
    solve of its rhs bit for bit. The epoch lives in a device word that
    each sweep advances; a host epoch frozen at capture would let the
    second replay accept the first one's tagged words without waiting."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    tiles = _synthetic_factor(lay, 7, "cuda")
    kernel, _, _ = _kernel_for(lay, tiles)
    gen = torch.Generator(device="cuda").manual_seed(9)
    r_static = torch.randn(lay.n, device="cuda", generator=gen)
    kernel(r_static)  # builds the kernel, its work tables and scratch before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_static = kernel(r_static)
    rhs, replays = [], []
    for _ in range(3):
        rhs.append(torch.randn(lay.n, device="cuda", generator=gen))
        r_static.copy_(rhs[-1])
        graph.replay()
        replays.append(y_static.clone())
    torch.cuda.synchronize()
    for r, y in zip(rhs, replays):
        assert torch.equal(y, kernel(r))
    assert not torch.equal(replays[0], replays[1])


# ----------------------------------------------------------------------
# The segments form.
# ----------------------------------------------------------------------


def _segment_problem(lengths, bw, seed):
    """A diagonally dominant SPD matrix of independent banded blocks of
    ``lengths`` rows laid end to end (bandwidth ``bw`` inside each, every
    band entry nonzero), as COO entries (both triangles) with its true
    segment bounds."""
    rng = np.random.default_rng(seed)
    bounds = np.r_[0, np.cumsum(lengths)].astype(np.int64)
    n = int(bounds[-1])
    seg = np.repeat(np.arange(len(lengths)), lengths)
    lo = np.concatenate([np.flatnonzero(seg[k:] == seg[:-k]) for k in range(1, bw + 1)])
    hi = np.concatenate([np.flatnonzero(seg[k:] == seg[:-k]) + k for k in range(1, bw + 1)])
    off = rng.standard_normal(len(lo))
    diag = 1.0 + np.bincount(lo, np.abs(off), n) + np.bincount(hi, np.abs(off), n)
    i = np.arange(n)
    return np.r_[lo, hi, i], np.r_[hi, lo, i], np.r_[off, off, diag], bounds


SEGMENT_CASES = [((1, 3, 40, 2, 7, 1, 1, 25, 12, 9), 1), ((5, 1, 38, 2, 17, 4, 4, 30, 11), 2),
                 ((40, 1, 2, 3, 33, 8, 1, 19), 3), ((1, 1, 6, 40, 2, 29, 13, 7, 4, 4, 21), 4)]


@pytest.mark.parametrize("lengths,bw", SEGMENT_CASES, ids=[f"bw{bw}" for _, bw in SEGMENT_CASES])
@pytest.mark.parametrize("cap", [None, 40], ids=["seg_rows", "cap40"])
def test_segment_bounds_and_layout(monkeypatch, lengths, bw, cap):
    """segment_bounds finds exactly the blocks' cuts; segment_band lays the
    segments out longest first (ties in band order) in chunks of at most
    SEG_THREADS segments and SEG_ROWS padded rows (``cap``: 40, for several
    chunks here; a longer segment alone),
    position-major: row j of a chunk's t-th segment at its first row + j T
    + t, every solver row once, padding marked -1, its band rows zero."""
    rows, cols, vals, bounds = _segment_problem(lengths, bw, seed=1)
    n = int(bounds[-1])
    np.testing.assert_array_equal(tts.segment_bounds(np.minimum(rows, cols), np.maximum(rows, cols), n), bounds)
    solver_row = np.random.default_rng(2).permutation(n)
    if cap is not None:
        monkeypatch.setattr(tts, "SEG_ROWS", cap)
    seg, ok = tts.segment_band(rows, cols, vals, bounds, bw, solver_row, 1e-6, 1.0)
    lens, chunks, order = seg.seg_len.numpy(), seg.chunks.numpy(), seg.order.numpy()
    assert ok and seg.n == n and seg.max_seg == max(lengths) and seg.bw == bw
    np.testing.assert_array_equal(lens, sorted(lengths, reverse=True))
    assert sorted(order[order >= 0]) == list(range(n)) and chunks[-1, 0] == len(lens) and chunks[-1, 1] == len(order)
    per = np.diff(chunks[:, 0])
    assert np.all(per >= 1) and np.all(per <= tts.SEG_THREADS)
    assert np.all(np.diff(chunks[:, 1]) == lens[chunks[:-1, 0]] * per)
    limit = min(tts.SEG_ROWS, tts.segment_chunk_rows(bw))
    assert np.all((np.diff(chunks[:, 1]) <= limit) | (per == 1)) and seg.rows == np.diff(chunks[:, 1]).max()
    band_of = np.empty(n, np.int64)
    band_of[solver_row] = np.arange(n)  # each solver row's band row
    starts = bounds[:-1][np.argsort(-np.diff(bounds), kind="stable")]  # each laid-out segment's first band row
    for c in range(len(per)):
        for t in range(per[c]):
            s = chunks[c, 0] + t
            at = chunks[c, 1] + np.arange(lens[chunks[c, 0]]) * per[c] + t
            np.testing.assert_array_equal(band_of[order[at[: lens[s]]]], starts[s] + np.arange(lens[s]))
            assert np.all(order[at[lens[s]:]] == -1) and not seg.band[at[lens[s]:]].any()


def _segments_and_tiles(lengths, bw, eps, seed):
    """The segments form (solver rows shuffled) and the f64 band tiles
    (B 64) of one matrix plus eps I, the dense regularized matrix, and its
    solver-order permutation."""
    rows, cols, vals, bounds = _segment_problem(lengths, bw, seed)
    n = int(bounds[-1])
    solver_row = np.random.default_rng(seed + 1).permutation(n)
    seg, ok = tts.segment_band(rows, cols, vals, bounds, bw, solver_row, eps, 1.0)
    assert ok and seg.max_seg == max(lengths) and seg.n_segments == len(lengths)
    lay = tts.make_band_layout(n, bw, 64)
    tiles = tts.scatter_band_aat(rows, cols, vals, lay, eps, 1.0, torch.float64)
    assert int(tts.band_cholesky(tiles, lay)) == 0
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    return seg, lay, tiles, dense + eps * np.eye(n), solver_row


@pytest.mark.parametrize("lengths,bw", SEGMENT_CASES, ids=[f"bw{bw}" for _, bw in SEGMENT_CASES])
def test_segments_solve_matches_tiles_and_pallas_interpret(lengths, bw):
    """band_segments_solve (the plain version on the CPU) against
    band_solve_ref on the f64 tiles of the same matrix, the JAX package's
    band_solve (interpret mode) on its own f64 tiles, and a dense solve:
    1e-6 (the segments' factor is rounded to f32 once), in the solver's
    order; f32 r gives f32 y within 1e-6 of the f64 r's."""
    jts, jnp = _jax()
    seg, lay, tiles, dense, solver_row = _segments_and_tiles(lengths, bw, 1e-6, seed=3)
    n = lay.n
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(n))
    before = dict(COUNTS)
    y = tts.band_segments_solve(seg, r)
    assert COUNTS == before and y.dtype == torch.float64
    r_band = r[torch.as_tensor(solver_row)]  # band row i holds solver row solver_row[i]
    y_tiles = torch.empty_like(r)
    y_tiles[torch.as_tensor(solver_row)] = tts.band_solve_ref(tiles, r_band, lay)
    rows, cols, vals, _ = _segment_problem(lengths, bw, seed=3)
    jlay = jts.make_band_layout(n, bw, 64)
    jtiles = jts.band_cholesky(jts.scatter_band_aat(rows, cols, vals, jlay, 1e-6, 1.0, jnp.float64), jlay)
    y_jax = torch.empty_like(r)
    y_jax[torch.as_tensor(solver_row)] = torch.as_tensor(np.array(
        jts.band_solve(jtiles, jnp.asarray(r_band.numpy()), jlay, interpret=True)))
    p = np.empty(n, np.int64)
    p[solver_row] = np.arange(n)
    y_dense = torch.as_tensor(np.linalg.solve(dense[np.ix_(p, p)], r.numpy()))  # the solver's order
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
    for other in (y_tiles, y_jax, y_dense):
        assert rel(y, other) < 1e-6
    y32 = tts.band_segments_solve(seg, r.float())
    assert y32.dtype == torch.float32 and rel(y32.double(), y) < 1e-6


def test_segments_solve_on_the_g50_route_torus():
    """The small odd torus of the G50 route test (5 x 24, 1,833
    constraints): its banded build takes the segments form (729 segments,
    the longest 14, no tile); its solve agrees with the tile form's
    (``segment_model=None``) to the f32 factors' rounding, and both
    calibrated solvers reach the 1e-10 target."""
    from cuadmm_tpu_torch.ops import chol as tchol
    from cuadmm_tpu_torch.ops import limits as lim
    from cuadmm_tpu_torch.ops.sparse import build_sparse_a
    from portbench.generators import toroidal_maxcut

    prob = toroidal_maxcut.generate(dict(rows=5, cols=24), 2**31 + 5)
    args = (prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num, prob.vec_len)
    sa = build_sparse_a(*args, torch.float64, torch.device("cpu"))
    card = lim.limits_for(85_017_493_504)
    timings = {}
    seg = tchol.build_normal_solver(*args, sa, "banded", torch.float64, torch.device("cpu"), applies=0,
                                    timings=timings, limits=card)
    tile = tchol.build_normal_solver(*args, sa, "banded", torch.float64, torch.device("cpu"), applies=0,
                                     limits=dataclasses.replace(card, segment_model=None))
    assert isinstance(seg.factor, tchol.SegmentFactor)
    assert isinstance(tile.factor, tchol.BandFactor) and tile.factor.form == "chain"
    assert (timings["band_segments"], timings["band_max_segment"], timings["band_bw"]) == (729, 14, 4)
    held = seg.factor.segments.band.numel() * 4  # the band's rows and the chunks' padding
    assert timings["band_layout"] == f"form=segments segments=729 max=14 bytes={held}"
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(prob.con_num))
    buf = tile.factor.buffer()
    buf[: prob.con_num] = r
    y_seg, y_tile = seg.factor.apply_head(r), tile.factor.apply(buf)[: prob.con_num]
    assert float(torch.linalg.norm(y_seg - y_tile.double()) / torch.linalg.norm(y_seg)) < 1e-5
    rhs = tchol.aat_matvec(sa, torch.as_tensor(np.random.default_rng(6).standard_normal(prob.con_num)))
    for neq in (seg, tile):
        assert float(neq.residual_norm(rhs, neq.solve(rhs))) < 1e-10


def test_long_segments_and_wide_bands_keep_the_tile_forms():
    """The segments form only within SEGMENT_MAX_BW and SEGMENT_MAX_ROWS and
    where its model beats the tile forms'; a band with a long segment (the
    2,500-row chain: two segments) builds the tile form as before."""
    from cuadmm_tpu_torch.ops import chol as tchol
    from cuadmm_tpu_torch.ops import limits as lim
    from cuadmm_tpu_torch.ops import sparse as tsparse
    from cuadmm_tpu_torch.structure import BlockStructure

    model = lim.SEGMENT_MODEL
    n = 139_192
    assert lim.segment_form(model, n, 4, 30, 1.0) and not lim.segment_form(None, n, 4, 30, 1.0)
    assert not lim.segment_form(model, n, 4, lim.SEGMENT_MAX_ROWS + 1, 1.0)
    assert not lim.segment_form(model, n, lim.SEGMENT_MAX_BW + 1, 30, 1.0)
    assert not lim.segment_form(model, n, 4, 30, model(n, 4, 30))
    assert lim.SEGMENT_MAX_ROWS <= tts.segment_chunk_rows(lim.SEGMENT_MAX_BW)
    A = _chain_a(2500)
    con, vec_len = A.shape
    coo = A.tocoo()
    args = (coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data, con, vec_len)
    sa = tsparse.build_sparse_a_pool(*args[:4], BlockStructure([("u", vec_len)], "pow2", 64, 0),
                                     torch.float64, torch.device("cpu"))
    timings = {}
    neq = tchol.build_normal_solver(*args, sa, "banded", torch.float64, torch.device("cpu"), applies=2,
                                    timings=timings)
    assert timings["band_max_segment"] > lim.SEGMENT_MAX_ROWS
    assert isinstance(neq.factor, tchol.BandFactor) and neq.factor.form == "chain"


def _card_segments(lengths, bw, seed):
    seg, _ = tts.segment_band(*_segment_problem(lengths, bw, seed)[:4], bw,
                              np.random.default_rng(seed).permutation(sum(lengths)), 1e-6, 1.0, "cuda")
    return seg


# G50's mix of lengths (1-30, mostly short) over many chunks, long
# segments at bandwidth 16 (a chunk of few), and the longest allowed.
CARD_SEGMENTS = [
    (tuple(np.random.default_rng(0).choice([1, 1, 2, 2, 3, 5, 8, 13, 30], 20000)), 4),
    ((300,) * 7 + (1, 2, 90), 16),
    ((512, 3, 1), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,bw", CARD_SEGMENTS, ids=["g50_mix_bw4", "long_bw16", "max_rows_bw1"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_segments_kernel_matches_plain_on_card(lengths, bw, dtype):
    """The segments kernel against band_segments_solve_ref on the card (f64
    arithmetic both: 1e-12 for f64 r; f32 r and y within one f32 rounding),
    y in r's dtype; bitwise repeatable; one k3_seg count and one launch an
    apply, no k3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    seg = _card_segments(lengths, bw, 7)
    r = torch.randn(seg.n, device="cuda", dtype=dtype, generator=torch.Generator(device="cuda").manual_seed(8))
    before = dict(COUNTS)
    y = tts.band_segments_solve(seg, r)
    torch.cuda.synchronize()
    assert COUNTS["k3_seg"] == before["k3_seg"] + 1 and COUNTS["k3"] == before["k3"]
    plain = tts.band_segments_solve_ref(seg, r.double())
    tol = 1e-12 if dtype == torch.float64 else 1e-7
    assert y.dtype == dtype and float(torch.linalg.norm(y.double() - plain) / torch.linalg.norm(plain)) < tol
    assert torch.equal(tts.band_segments_solve(seg, r), y)
    assert _sweeps_per_solve(lambda: tts.band_segments_solve(seg, r)) == 1


@pytest.mark.cuda
def test_captured_segments_solve_replays_on_card():
    """A segments solve captured into a CUDA graph, replayed twice with new
    right-hand sides copied in: each replay equals an eager solve of its
    rhs bit for bit, and the replays differ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seg = _card_segments(CARD_SEGMENTS[0][0], 4, 9)
    gen = torch.Generator(device="cuda").manual_seed(10)
    r_static = torch.randn(seg.n, dtype=torch.float64, device="cuda", generator=gen)
    tts.band_segments_solve(seg, r_static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_static = tts.band_segments_solve(seg, r_static)
    rhs, replays = [], []
    for _ in range(2):
        rhs.append(torch.randn(seg.n, dtype=torch.float64, device="cuda", generator=gen))
        r_static.copy_(rhs[-1])
        graph.replay()
        replays.append(y_static.clone())
    torch.cuda.synchronize()
    for r, y in zip(rhs, replays):
        assert torch.equal(y, tts.band_segments_solve(seg, r))
    assert not torch.equal(replays[0], replays[1])
