"""Packed and banded block-triangular Cholesky and the streaming solves (K2, K3).

Port of cuadmm_tpu/ops/tri_stream.py. Past dense_chol_max the factor of the
regularized AA^T lives as B x B tiles: the packed lower triangle (T =
nb(nb+1)/2 tiles, row-major) or, when AA^T is banded under an RCM
permutation, a block band (T = nb(nbw+1) slots, row-major). The layouts,
the meta tables and the scatters keep the JAX names and agree with them
array for array (tests/test_torch_tri_stream.py).

- ``packed_cholesky`` / ``band_cholesky``: right-looking blocked Cholesky
  in place, from two steps written in torch (the JAX package runs them
  outside any Pallas kernel): ``_diag_panel_step`` factors and inverts the
  diagonal tile and scales its column panel, ``_pair_chunk_step`` subtracts
  chunks of 64 panel outer products from the trailing tiles (~256 MB of
  f32 transients each at B = 1024). Diagonal tiles come out INVERTED, so a
  diagonal solve step is a matvec. A failed tile is reported, not passed
  over: ``torch.linalg.cholesky_ex`` returns a partial factor and a status
  instead of NaN, so the statuses of all tiles are OR-ed on the device.
- ``packed_solve`` / ``band_solve``: y = (L L^T)^{-1} r by a forward sweep
  L x = r in row order and a backward sweep L^T y = x in reverse column
  order, each reading every tile once. On a CUDA tensor they launch the
  hand-written kernel ``csrc/tri_stream.cu`` (one source for both layouts,
  one persistent launch per sweep, driven by work tables built once per
  layout from the meta tables) or raise; on a CPU
  tensor they run the plain versions ``packed_solve_ref`` /
  ``band_solve_ref``.
- The one-hop form (``band_form``: bands with nbw <= ``NBW_CHAIN`` whose
  derived tiles fit the card beside them): ``band_chain``
  forms W_ij = inv(L_ii) L_ij and Ut_ji = inv(L_jj)^T L_ij^T once per
  factor, and ``band_solve(..., chain=)`` sweeps x_i = inv(L_ii) r_i -
  sum_j W_ij x_j and y_i = inv(L_ii)^T x_i - sum_j Ut_ij y_j, one wait on
  the newest solved block per block step where the two-hop form waits
  twice (csrc/tri_stream.cu says why). The same tiles are read per sweep.

Dropped from the JAX package: the pow2 padding of panels and chunks, the
sentinel-tile writes and the scan of dynamic slices, which only bound
XLA's compiles and temporaries. The tile array keeps its trailing
(T+1)-th tile, so JAX tiles carry over one to one (convert.py); the port
never writes it.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cuadmm_tpu_torch import _build, trace
from cuadmm_tpu_torch.ops import limits
from cuadmm_tpu_torch.ops.limits import BAND_MODEL, NBW_CHAIN

UPDATE_CHUNK = 64  # panel outer products per _pair_chunk_step

# Each wrapper's entry in trace.COUNTS (a call queues the forward and
# the backward sweep of csrc/tri_stream.cu, one persistent launch each).
COUNTER = {"packed_solve": "k2", "band_solve": "k3"}

# NBW_CHAIN (ops/limits.py, beside K3's model): the widest block band that
# takes the one-hop form; wider bands keep the two-hop form, where the
# derived tiles would near triple the factor (k3_ab.py --forms times both).
CHAIN_CHUNK = 8  # derived tiles formed per f64 product in band_chain

_CTAS: dict = {}  # (variant, device index, block) -> co-resident CTAs of one two-hop sweep
_PLANS: dict = {}  # (variant, device index, block) -> one-hop ring depth and co-resident CTAs
_STEPS: dict = {}  # (form, layout, device) -> work tables and tagged scratch of both sweeps


class PackedLayout(NamedTuple):
    """Static description of a packed block-triangular matrix."""

    n: int  # logical dimension
    n_pad: int  # nb * block
    block: int
    nb: int  # number of block rows
    T: int  # nb*(nb+1)//2 tiles


def make_layout(n: int, block: int = 1024) -> PackedLayout:
    nb = -(-n // block)
    return PackedLayout(n=n, n_pad=nb * block, block=block, nb=nb, T=nb * (nb + 1) // 2)


def tid(i: int, j: int) -> int:
    """Packed tile id of block (i, j), i >= j (row-major lower triangle)."""
    return i * (i + 1) // 2 + j


class BandLayout(NamedTuple):
    """Static description of a banded-blocked lower factor."""

    n: int  # logical dimension
    n_pad: int  # nb * block
    block: int
    nb: int  # number of block rows
    nbw: int  # block bandwidth: tile (i, j) may be nonzero iff i-j <= nbw
    T: int  # nb * (nbw + 1) allocated band slots (some top-left unused)


def make_band_layout(n: int, bw: int, block: int = 0, model: Optional[Callable] = None) -> BandLayout:
    """Layout for scalar bandwidth ``bw``; ``block=0`` picks B in
    {1024, 512, 256} by ``model(T, B, nb)``, the seconds of a solve over T
    tiles of B^2 in nb block rows (None: K3's on the card,
    ``ops/limits.py::BAND_MODEL``; ``CardLimits.bound_band_model()`` also
    knows at which blocks the derived tiles fit the card); the first B
    wins a tie."""
    if block <= 0:
        model = BAND_MODEL if model is None else model
        best = None
        for B in (1024, 512, 256):
            nb = -(-n // B)
            nbw = min(nb - 1, (bw + B - 1) // B)
            t_model = model(nb * (nbw + 1), B, nb)
            if best is None or t_model < best[0]:
                best = (t_model, B)
        block = best[1]
    nb = -(-n // block)
    nbw = min(nb - 1, (bw + block - 1) // block)
    return BandLayout(n=n, n_pad=nb * block, block=block, nb=nb, nbw=nbw, T=nb * (nbw + 1))


def tid_band(i, j, lay: BandLayout):
    """Band slot of tile (i, j), i - nbw <= j <= i (row-major band)."""
    return i * (lay.nbw + 1) + (lay.nbw - (i - j))


def band_form(lay: BandLayout, max_bytes: Optional[int] = None) -> str:
    """K3's form for ``lay`` on a card whose band may hold ``max_bytes``
    (``CardLimits.band_max_bytes``; None: no limit): "chain" (one-hop) at
    nbw <= NBW_CHAIN where the derived tiles fit beside the band, else
    "two_hop" (``limits.band_form``)."""
    return limits.band_form(lay.T, lay.block, lay.nb, max_bytes)


def chain_slot(i, j, lay: BandLayout):
    """Slot of off-diagonal tile (i, j), i - nbw <= j < i, among a chain
    half's nb * nbw (W first, Ut second, each row-major like the band)."""
    return i * lay.nbw + (lay.nbw - (i - j))


def band_bytes(lay: BandLayout, form: str) -> int:
    """The f32 bytes a banded solver holds in ``form``: the band's T tiles,
    and in the one-hop form its derived tiles (2 nb nbw)."""
    return limits.band_held_bytes(lay.T, lay.block, lay.nb, form)


def band_chain(tiles: torch.Tensor, lay: BandLayout) -> torch.Tensor:
    """The one-hop form's derived tiles of a factored band (diagonal tiles
    inverted): (2 nb nbw, B, B) in the tiles' dtype and device, W_ij =
    inv(L_ii) L_ij at ``chain_slot(i, j)`` and Ut_ji = inv(L_jj)^T L_ij^T at
    nb nbw + ``chain_slot(i, j)``, each formed in f64 (``torch.matmul``,
    CHAIN_CHUNK tiles at a time) and rounded once. Slots of the top-left
    corner (j < 0) are zero and never read."""
    B, half = lay.block, lay.nb * lay.nbw
    out = torch.zeros((2 * half, B, B), dtype=tiles.dtype, device=tiles.device)
    pairs = [(i, j) for i in range(lay.nb) for j in range(max(0, i - lay.nbw), i)]
    f64 = torch.float64
    for s in range(0, len(pairs), CHAIN_CHUNK):
        chunk = pairs[s : s + CHAIN_CHUNK]
        idx = lambda ids: torch.as_tensor(ids, dtype=torch.int64, device=tiles.device)
        l_ij = tiles.index_select(0, idx([tid_band(i, j, lay) for i, j in chunk])).to(f64)
        inv_i = tiles.index_select(0, idx([tid_band(i, i, lay) for i, _ in chunk])).to(f64)
        slots = idx([chain_slot(i, j, lay) for i, j in chunk])
        out.index_copy_(0, slots, torch.matmul(inv_i, l_ij).to(tiles.dtype))
        del inv_i
        inv_j = tiles.index_select(0, idx([tid_band(j, j, lay) for _, j in chunk])).to(f64)
        out.index_copy_(0, slots + half, torch.matmul(inv_j.mT, l_ij.mT).to(tiles.dtype))
        del inv_j, l_ij
    return out


# ----------------------------------------------------------------------
# Meta tables: the order in which each sweep visits the tiles.
# ----------------------------------------------------------------------


def _fwd_meta(lay: PackedLayout):
    rows = np.concatenate([np.full(i + 1, i, np.int32) for i in range(lay.nb)])
    cols = np.concatenate([np.arange(i + 1, dtype=np.int32) for i in range(lay.nb)])
    return rows, cols


def _table(entries) -> Tuple[np.ndarray, ...]:
    return tuple(np.asarray(col, np.int32) for col in zip(*entries))


def _bwd_meta(lay: PackedLayout):
    """(order, rows, cols, first): columns i = nb-1..0, rows j = nb-1..i."""
    return _table(
        (tid(j, i), j, i, int(pos == 0))
        for i in range(lay.nb - 1, -1, -1)
        for pos, j in enumerate(range(lay.nb - 1, i - 1, -1))
    )


def _fwd_band_meta(lay: BandLayout):
    """(order, rows, cols, first): rows i = 0..nb-1, cols j = i-nbw..i."""
    return _table(
        (tid_band(i, j, lay), i, j, int(pos == 0))
        for i in range(lay.nb)
        for pos, j in enumerate(range(max(0, i - lay.nbw), i + 1))
    )


def _bwd_band_meta(lay: BandLayout):
    """(order, rows, cols, first): columns i = nb-1..0, rows j = i+nbw..i."""
    return _table(
        (tid_band(j, i, lay), j, i, int(pos == 0))
        for i in range(lay.nb - 1, -1, -1)
        for pos, j in enumerate(range(min(lay.nb - 1, i + lay.nbw), i - 1, -1))
    )


def _sweep_tables(lay) -> Tuple[tuple, tuple]:
    """Both sweeps of ``lay`` as (order, rows, cols, first) tables."""
    if isinstance(lay, BandLayout):
        return _fwd_band_meta(lay), _bwd_band_meta(lay)
    rows, cols = _fwd_meta(lay)
    order = np.arange(lay.T, dtype=np.int32)
    return (order, rows, cols, (cols == 0).astype(np.int32)), _bwd_meta(lay)


# ----------------------------------------------------------------------
# Scatter of AA^T + eps*scale*I into tiles.
# ----------------------------------------------------------------------


def _diag_entries(lay, eps: float, diag_mean: float, slot_of_block):
    """COO entries of the regularized diagonal: eps*scale on the first n
    rows, a unit diagonal on the padding rows."""
    scale = max(float(diag_mean), 1.0)
    all_d = np.arange(lay.n_pad, dtype=np.int64)
    vd = np.full(lay.n_pad, eps * scale)
    vd[lay.n :] = 1.0
    return slot_of_block(all_d // lay.block), all_d % lay.block, vd


def _scatter(t, ri, ci, v, lay, dtype, device) -> torch.Tensor:
    """(T+1, B, B) zeros with the COO entries added (duplicates add)."""
    tiles = torch.zeros((lay.T + 1, lay.block, lay.block), dtype=dtype, device=device)
    idx = tuple(torch.as_tensor(np.asarray(a, np.int64), device=device) for a in (t, ri, ci))
    tiles.index_put_(idx, torch.as_tensor(np.asarray(v), device=device).to(dtype), accumulate=True)
    return tiles


def scatter_packed_aat(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    lay: PackedLayout,
    eps: float,
    diag_mean: float,
    dtype: torch.dtype,
    device=None,
) -> torch.Tensor:
    """Packed tiles (T+1, B, B) of AA^T + eps*scale*I from COO (host
    indices), on ``device``. Only lower-triangle entries are stored (r >= c);
    padding rows get a unit diagonal."""
    keep = rows >= cols
    r, c, v = rows[keep], cols[keep], vals[keep]
    bi, bj = r // lay.block, c // lay.block
    t = (bi * (bi + 1) // 2 + bj).astype(np.int64)
    t_d, rd, vd = _diag_entries(lay, eps, diag_mean, lambda b: b * (b + 1) // 2 + b)
    return _scatter(
        np.concatenate([t, t_d]),
        np.concatenate([r % lay.block, rd]),
        np.concatenate([c % lay.block, rd]),
        np.concatenate([v, vd]),
        lay, dtype, device,
    )


def scatter_band_aat(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    lay: BandLayout,
    eps: float,
    diag_mean: float,
    dtype: torch.dtype,
    device=None,
) -> torch.Tensor:
    """Band tiles (T+1, B, B) of (permuted) AA^T + eps*scale*I from COO.

    ``rows``/``cols`` are indices AFTER the bandwidth-reducing permutation;
    an entry outside the band is an error. Padding rows get a unit diagonal.
    """
    keep = rows >= cols
    r, c, v = rows[keep], cols[keep], vals[keep]
    bi, bj = r // lay.block, c // lay.block
    if len(bi) and int((bi - bj).max()) > lay.nbw:
        raise ValueError("entry outside the declared band")
    t = (bi * (lay.nbw + 1) + (lay.nbw - (bi - bj))).astype(np.int64)
    t_d, rd, vd = _diag_entries(lay, eps, diag_mean, lambda b: b * (lay.nbw + 1) + lay.nbw)
    return _scatter(
        np.concatenate([t, t_d]),
        np.concatenate([r % lay.block, rd]),
        np.concatenate([c % lay.block, rd]),
        np.concatenate([v, vd]),
        lay, dtype, device,
    )


# ----------------------------------------------------------------------
# Elimination.
# ----------------------------------------------------------------------


def _diag_panel_step(tiles: torch.Tensor, diag_id: int, col_ids: torch.Tensor):
    """One elimination step, in place: replace diagonal tile ``diag_id`` by
    inv(L_kk) and the column panel ``col_ids`` by panel @ inv(L_kk)^T.
    Returns (panel, info), info being cholesky_ex's status (0 = success)."""
    dk = tiles[diag_id]
    # Diagonal tiles store only the lower triangle; rebuild the symmetric
    # block explicitly before factoring it.
    lkk, info = torch.linalg.cholesky_ex(torch.tril(dk) + torch.tril(dk, -1).mT)
    eye = torch.eye(dk.shape[0], dtype=dk.dtype, device=dk.device)
    ikk = torch.linalg.solve_triangular(lkk, eye, upper=False)
    tiles[diag_id] = ikk
    panel = tiles.index_select(0, col_ids) @ ikk.mT
    tiles.index_copy_(0, col_ids, panel)
    return panel, info


def _pair_chunk_step(tiles, panel, pi, pj, dst) -> None:
    """Subtract one chunk of panel outer products L_ik L_jk^T from the
    trailing tiles ``dst`` (distinct within a chunk), in place."""
    tiles.index_add_(0, dst, panel[pi] @ panel[pj].mT, alpha=-1)


def _eliminate(tiles: torch.Tensor, nb: int, reach: int, tile_id: Callable[[int, int], int]) -> torch.Tensor:
    """Right-looking blocked Cholesky over tiles (i, j), j <= i <= j + reach;
    diagonal tiles come out inverted. Returns the OR of every diagonal
    tile's cholesky_ex status, on the device (nonzero = failed)."""
    dev = tiles.device
    cols, pairs, col_at, pair_at = [], [], [0], [0]
    for k in range(nb):  # host schedule, uploaded once
        below = range(k + 1, min(nb, k + reach + 1))
        cols += [tile_id(i, k) for i in below]
        pairs += [(i - k - 1, j - k - 1, tile_id(i, j)) for i in below for j in range(k + 1, i + 1)]
        col_at.append(len(cols))
        pair_at.append(len(pairs))
    col_ids = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    pi, pj, dst = (
        torch.as_tensor(np.asarray(p, np.int64).reshape(-1), device=dev)
        for p in (zip(*pairs) if pairs else ((), (), ()))
    )
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for k in range(nb):
        panel, status = _diag_panel_step(tiles, tile_id(k, k), col_ids[col_at[k] : col_at[k + 1]])
        info.bitwise_or_(status)
        for s in range(pair_at[k], pair_at[k + 1], UPDATE_CHUNK):
            e = min(s + UPDATE_CHUNK, pair_at[k + 1])
            _pair_chunk_step(tiles, panel, pi[s:e], pj[s:e], dst[s:e])
    return info


def packed_cholesky(tiles: torch.Tensor, lay: PackedLayout) -> torch.Tensor:
    """Blocked Cholesky of packed tiles in place; diagonal tiles come out
    INVERTED (inv(L_kk)), as the streaming solves consume them. Returns the
    device status, nonzero if a diagonal tile was not positive definite."""
    return _eliminate(tiles, lay.nb, lay.nb - 1, tid)


def band_cholesky(tiles: torch.Tensor, lay: BandLayout) -> torch.Tensor:
    """Blocked Cholesky within the band, in place (banded Cholesky has no
    fill outside the band); diagonal tiles come out INVERTED. Returns the
    device status, nonzero if a diagonal tile was not positive definite."""
    return _eliminate(tiles, lay.nb, lay.nbw, lambda i, j: tid_band(i, j, lay))


# ----------------------------------------------------------------------
# Streaming solves: plain versions.
# ----------------------------------------------------------------------


def _sweep_ref(tiles: torch.Tensor, rhs: torch.Tensor, table, transpose: bool) -> torch.Tensor:
    """One sweep over ``table`` (order, rows, cols, first), in the tiles'
    dtype. Forward (L x = rhs) solves block rows; backward (L^T y = rhs,
    ``transpose``) solves block columns with tile^T. A block's residual
    starts at its ``first`` tile, drops each off-diagonal product in table
    order, and meets the inverted diagonal tile last."""
    B = tiles.shape[-1]
    out = torch.zeros_like(rhs)
    acc = None
    for t, i, j, first in zip(*(a.tolist() for a in table)):
        s, o = (j, i) if transpose else (i, j)  # block solved, block read
        tile = tiles[t].mT if transpose else tiles[t]
        if first:
            acc = rhs[s * B : (s + 1) * B].clone()
        if o != s:
            acc -= tile @ out[o * B : (o + 1) * B]
        else:
            out[s * B : (s + 1) * B] = tile @ acc
    return out


def _solve_ref(tiles: torch.Tensor, r: torch.Tensor, lay) -> torch.Tensor:
    fwd, bwd = _sweep_tables(lay)
    rp = torch.nn.functional.pad(r.to(tiles.dtype), (0, lay.n_pad - r.shape[0]))
    y = _sweep_ref(tiles, _sweep_ref(tiles, rp, fwd, False), bwd, True)
    return y[: r.shape[0]].to(r.dtype)


def packed_solve_ref(tiles: torch.Tensor, r: torch.Tensor, lay: PackedLayout) -> torch.Tensor:
    """Plain version of K2: y = (L L^T)^{-1} r over packed tiles."""
    return _solve_ref(tiles, r, lay)


def band_solve_ref(tiles: torch.Tensor, r: torch.Tensor, lay: BandLayout) -> torch.Tensor:
    """Plain version of K3: y = (L L^T)^{-1} r over band tiles."""
    return _solve_ref(tiles, r, lay)


# ----------------------------------------------------------------------
# Streaming solves: the kernel.
# ----------------------------------------------------------------------


def _steps(table, transpose: bool) -> dict:
    """A sweep's table grouped by the block each step solves: per step the
    block and its diagonal tile, and the off-diagonal tiles (in table
    order) with the solved block each reads. Host int32 arrays."""
    order, rows, cols, first = table
    solved, read = (cols, rows) if transpose else (rows, cols)
    start = np.flatnonzero(first)
    end = np.r_[start[1:], len(order)] - 1  # each step's last entry: its diagonal
    off = np.ones(len(order), bool)
    off[end] = False
    return dict(
        step_blk=np.ascontiguousarray(solved[end], np.int32),
        diag_tile=np.ascontiguousarray(order[end], np.int32),
        off_start=np.ascontiguousarray(np.r_[0, np.cumsum(end - start)], np.int32),
        off_tile=order[off].astype(np.int32),
        off_blk=read[off].astype(np.int32),
    )


SLAB = 8  # output entries per two-hop work item (csrc/tri_stream.cu kSlab)
CHAIN_ITEM = 16  # output entries per one-hop work item (csrc/tri_stream.cu kS)


def _work_table(st: dict, B: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A sweep's work items for the persistent kernel, in step order.

    Per step: B/8 output slabs of each off-diagonal tile (tile-major, in
    table order), then the B/8 slabs of its diagonal tile. items (n, 4)
    int32: tile, step, slab, partial row (-1 for a diagonal item). steps
    (nb, 3) int32: block solved, first partial row, partial rows (one per
    off-diagonal tile, summed in that order). row_blk: the solved block
    each partial row's tile reads.
    """
    slabs = B // SLAB
    e = np.arange(slabs)
    items = []
    for s in range(len(st["step_blk"])):
        a, b = int(st["off_start"][s]), int(st["off_start"][s + 1])
        slot = np.repeat(np.arange(a, b), slabs)
        items.append(np.stack([st["off_tile"][slot], np.full(len(slot), s), np.tile(e, b - a), slot], 1))
        items.append(np.stack([np.full(slabs, st["diag_tile"][s]), np.full(slabs, s), e, np.full(slabs, -1)], 1))
    steps = np.stack([st["step_blk"], st["off_start"][:-1], np.diff(st["off_start"])], 1)
    return (np.concatenate(items).astype(np.int32), steps.astype(np.int32),
            np.ascontiguousarray(st["off_blk"], np.int32))


def _chain_tables(lay: BandLayout) -> list:
    """Both sweeps' one-hop tables (host int32): steps (nb, 4) block solved,
    diagonal tile, first chain entry, chain entries; offs (entries, 2)
    chain tile and the solved block it multiplies, the newest block last
    (forward j = i-nbw..i-1 into W, backward j = i+nbw..i+1 into Ut)."""
    half = lay.nb * lay.nbw
    out = []
    for transpose in (False, True):
        blocks = range(lay.nb - 1, -1, -1) if transpose else range(lay.nb)
        steps, offs = [], []
        for i in blocks:
            if transpose:
                reads = [(half + chain_slot(j, i, lay), j) for j in range(min(lay.nb - 1, i + lay.nbw), i, -1)]
            else:
                reads = [(chain_slot(i, j, lay), j) for j in range(max(0, i - lay.nbw), i)]
            steps.append((i, tid_band(i, i, lay), len(offs), len(reads)))
            offs += reads
        out.append(dict(steps=np.asarray(steps, np.int32).reshape(-1, 4),
                        offs=np.asarray(offs or [(0, 0)], np.int32).reshape(-1, 2)))
    return out


def _device_steps(lay, device: torch.device, form: str = "two_hop") -> dict:
    """Both sweeps' work tables on ``device`` (built once per layout and
    form), the tagged scratch they share (solved vector and, for the
    two-hop form, partial rows: 64-bit words {value, epoch}), and the
    device word holding the next sweep's epoch (the kernel advances it
    after each sweep, so a CUDA graph replaying a solve tags each replay
    anew)."""
    key = (form, type(lay).__name__, tuple(lay), str(device))
    if key not in _STEPS:
        sweeps, rows = [], 0
        if form == "chain":
            sweeps = [{k: torch.as_tensor(v, device=device) for k, v in sw.items()} for sw in _chain_tables(lay)]
        else:
            rows = 1
            for table, transpose in zip(_sweep_tables(lay), (False, True)):
                items, steps, row_blk = _work_table(_steps(table, transpose), lay.block)
                rows = max(rows, len(row_blk))
                sweeps.append(dict(items=torch.as_tensor(items, device=device), n_items=len(items),
                                   steps=torch.as_tensor(steps, device=device),
                                   row_blk=torch.as_tensor(np.r_[row_blk, 0].astype(np.int32), device=device)))
        _STEPS[key] = dict(
            sweeps=sweeps,
            solved=torch.zeros(lay.n_pad, dtype=torch.int64, device=device),
            parts=torch.zeros(rows * lay.block, dtype=torch.int64, device=device) if rows else None,
            epoch=torch.ones(1, dtype=torch.int32, device=device),  # read as unsigned; fresh scratch tags 0
        )
    return _STEPS[key]


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuadmm_cuda_error_string(err).decode()
        raise RuntimeError(f"tri_stream {what} failed: {msg} (cudaError {err})")


_LIBS: dict = {}  # variant -> the loaded kernel library, built on its first CUDA launch
# A variant's library name and nvcc flags: k3_ab.py's timeline build
# records %globaltimer stamps; the library that ships has none.
VARIANTS = {None: (), "stamps": ("-DCUADMM_TRI_STAMPS",)}


def _load(variant: Optional[str] = None) -> ctypes.CDLL:
    if variant not in _LIBS:
        lib = _build.load("tri_stream", variant=variant, flags=VARIANTS[variant])
        P, I = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.cuadmm_tri_stream_fwd, lib.cuadmm_tri_stream_bwd):
            fn.argtypes = [P, I, P, I] + [P] * 6 + [P, I, P]
            fn.restype = I
        for fn in (lib.cuadmm_tri_chain_fwd, lib.cuadmm_tri_chain_bwd):
            fn.argtypes = [P, P, I, I, I, P, P, P, P, P, P, I, P]
            fn.restype = I
        lib.cuadmm_tri_stream_capacity.argtypes = [I, ctypes.POINTER(I)]
        lib.cuadmm_tri_stream_capacity.restype = I
        lib.cuadmm_tri_chain_plan.argtypes = [I, ctypes.POINTER(I), ctypes.POINTER(I)]
        lib.cuadmm_tri_chain_plan.restype = I
        lib.cuadmm_cuda_error_string.argtypes = [I]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        if variant == "stamps":
            lib.cuadmm_tri_stream_set_stamps.argtypes = [P, P]
            lib.cuadmm_tri_stream_set_stamps.restype = I
        _LIBS[variant] = lib
    return _LIBS[variant]


def _capacity(lib: ctypes.CDLL, idx: int, B: int, variant: Optional[str] = None) -> int:
    """Co-resident CTAs of one two-hop sweep on device ``idx`` at block B
    (cached)."""
    key = (variant, idx, B)
    if key not in _CTAS:
        n = ctypes.c_int(0)
        _check(lib, lib.cuadmm_tri_stream_capacity(B, ctypes.byref(n)), "occupancy query")
        _CTAS[key] = n.value
    return _CTAS[key]


def _chain_plan(lib: ctypes.CDLL, idx: int, B: int, variant: Optional[str] = None) -> Tuple[int, int]:
    """The one-hop kernel's ring depth and co-resident CTAs on device
    ``idx`` at block B (cached; sets the kernel's shared memory attribute
    on the first call)."""
    key = (variant, idx, B)
    if key not in _PLANS:
        stages, ctas = ctypes.c_int(0), ctypes.c_int(0)
        _check(lib, lib.cuadmm_tri_chain_plan(B, ctypes.byref(stages), ctypes.byref(ctas)), "one-hop plan")
        _PLANS[key] = (stages.value, ctas.value)
    return _PLANS[key]


def _check_chain(chain: torch.Tensor, tiles: torch.Tensor, lay: BandLayout) -> None:
    B = lay.block
    want = (2 * lay.nb * lay.nbw, B, B)
    if tuple(chain.shape) != want:
        raise ValueError(f"need chain tiles {want} (band_chain), got {tuple(chain.shape)}")
    if chain.device != tiles.device or chain.dtype != tiles.dtype:
        raise ValueError(f"chain tiles on {chain.device} as {chain.dtype}, band tiles on {tiles.device} "
                         f"as {tiles.dtype}")
    if not chain.is_contiguous() or chain.data_ptr() % 16:
        raise ValueError("chain tiles must be contiguous and 16-byte aligned")


def _solve(tiles: torch.Tensor, r: torch.Tensor, lay, name: str, chain: Optional[torch.Tensor] = None,
           form: str = "two_hop", variant: Optional[str] = None) -> torch.Tensor:
    B = lay.block
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (B, B) or tiles.shape[0] < lay.T:
        raise ValueError(f"need tiles (>= {lay.T}, {B}, {B}), got {tuple(tiles.shape)}")
    if r.dim() != 1 or r.shape[0] > lay.n_pad:
        raise ValueError(f"need r of length <= n_pad={lay.n_pad}, got {tuple(r.shape)}")
    if tiles.device != r.device:
        raise ValueError(f"tiles on {tiles.device} but r on {r.device}")
    if chain is not None:
        _check_chain(chain, tiles, lay)
    if tiles.device.type == "cpu":
        return _solve_ref(tiles, r, lay)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    if tiles.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 tiles, got {tiles.dtype}")
    if B % 128 or not 128 <= B <= 1024:
        raise ValueError(f"the kernel takes a block of 128..1024 in steps of 128, got {B}")
    if not tiles.is_contiguous() or tiles.data_ptr() % 16:
        raise ValueError("tiles must be contiguous and 16-byte aligned")
    if form == "chain" and chain is None:
        raise ValueError(f"nbw {lay.nbw} in the one-hop form needs its derived tiles: pass "
                         "chain=band_chain(tiles, lay), or form='two_hop'")
    lib = _load(variant)
    dev = tiles.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        tab = _device_steps(lay, dev, form)
        rp = torch.nn.functional.pad(r.to(torch.float32), (0, lay.n_pad - r.shape[0])).contiguous()
        x = torch.empty(lay.n_pad, dtype=torch.float32, device=dev)
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(idx).cuda_stream
        # Each launched sweep reads the epoch from its device word and
        # advances it after itself (wrapping past 0 after 2^32 sweeps), so
        # the scratch never needs a reset.
        if form == "chain":
            stages, ctas = _chain_plan(lib, idx, B, variant)
            fns = (lib.cuadmm_tri_chain_fwd, lib.cuadmm_tri_chain_bwd)
            for fn, sw, rhs, out in zip(fns, tab["sweeps"], (rp, x), (x, y)):
                err = fn(
                    tiles.data_ptr(), chain.data_ptr(), B, lay.nb, stages, sw["steps"].data_ptr(),
                    sw["offs"].data_ptr(), rhs.data_ptr(), out.data_ptr(), tab["solved"].data_ptr(),
                    tab["epoch"].data_ptr(), ctas, stream,
                )
                _check(lib, err, f"{name} launch")
        else:
            ctas = _capacity(lib, idx, B, variant)
            fns = (lib.cuadmm_tri_stream_fwd, lib.cuadmm_tri_stream_bwd)
            for fn, sw, rhs, out in zip(fns, tab["sweeps"], (rp, x), (x, y)):
                err = fn(
                    tiles.data_ptr(), B, sw["items"].data_ptr(), sw["n_items"], sw["steps"].data_ptr(),
                    sw["row_blk"].data_ptr(), rhs.data_ptr(), out.data_ptr(), tab["solved"].data_ptr(),
                    tab["parts"].data_ptr(), tab["epoch"].data_ptr(), ctas, stream,
                )
                _check(lib, err, f"{name} launch")
    trace.COUNTS[COUNTER[name]] += 1
    return y[: r.shape[0]].to(r.dtype)


def packed_solve(tiles: torch.Tensor, r: torch.Tensor, lay: PackedLayout) -> torch.Tensor:
    """y = (L L^T)^{-1} r over packed tiles (K2). ``r`` has at most n_pad
    entries (zero-padded to n_pad); y has r's length and dtype. On CUDA the
    tiles must be float32 and the kernel is queued on the current stream
    without synchronizing."""
    return _solve(tiles, r, lay, "packed_solve")


def band_solve(tiles: torch.Tensor, r: torch.Tensor, lay: BandLayout, chain: Optional[torch.Tensor] = None,
               form: Optional[str] = None) -> torch.Tensor:
    """y = (L L^T)^{-1} r over band tiles (K3); the contract of
    ``packed_solve``. ``form``: "chain" or "two_hop", the ``band_form``
    the caller's derived tiles were made for (None: ``band_form(lay)``,
    one-hop at nbw <= NBW_CHAIN). The one-hop form on CUDA needs its
    derived tiles, ``chain=band_chain(tiles, lay)``, and raises without
    them; the two-hop form ignores ``chain``. On the CPU the plain version
    reads ``tiles`` alone."""
    form = form or band_form(lay)
    if form not in ("chain", "two_hop"):
        raise ValueError(f"form must be 'chain' or 'two_hop', got {form!r}")
    return _solve(tiles, r, lay, "band_solve", chain=chain if form == "chain" else None, form=form)
