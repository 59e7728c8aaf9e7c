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
- The segments form (``SegmentBand``, ``band_segments_solve``): a band
  whose order falls apart into short independent segments (no nonzero
  crosses a cut: ``segment_bounds``) is factored segment by segment
  (``segment_cholesky``, f64 on the host, one batched Cholesky a segment
  length) into its band rows alone, (n, bw + 1) f32, and solved in one
  launch, one thread a segment, forward and backward. No tile exists;
  what bounds a solve is a launch and the longest segment's chain of
  dependent rows, not bytes (csrc/tri_stream.cu says how the kernel
  keeps the bytes off that chain). ``band_segments_solve_ref`` is its
  plain version.

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

# Each wrapper's entry in trace.COUNTS (a tile form's call queues the
# forward and the backward sweep of csrc/tri_stream.cu, one persistent
# launch each; the segments form's call one launch).
COUNTER = {"packed_solve": "k2", "band_solve": "k3", "band_segments_solve": "k3_seg"}

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
# The segments form: a narrow band's independent segments.
# ----------------------------------------------------------------------

SEG_THREADS = 128  # segments a CTA solves, one a thread (csrc/tri_stream.cu kSegThreads)
SEG_SMEM = 48 * 1024  # shared memory a CTA stages its rows in (csrc/tri_stream.cu kSegSmem)
SEG_ROWS = 256  # rows a CTA's chunk holds at most, unless its one segment is longer


class SegmentBand(NamedTuple):
    """K3's segments form of a factored band, on one device.

    The band's independent segments, longest first (ties in band order),
    are cut into chunks, one a CTA: at most SEG_THREADS segments and
    SEG_ROWS rows (a longer segment alone). A chunk of T segments, the
    longest M rows, holds M T rows, position-major: row j of its t-th
    segment at its first row + j T + t, the rows past a shorter segment's
    end padding. So a warp's threads read neighbouring words at every
    step of their chains.

    band: (N, bw + 1) f32, row q holding L[q, q-bw..q-1] (zero before its
    segment's first row, and on padding) and, last, 1 / L[q, q]; order:
    (N,) int32, the solver row of each row, -1 on padding; seg_len: (S,)
    int32, each segment's rows; chunks: (C + 1, 2) int32, each chunk's
    first segment and first row, then (S, N); rows: the most rows a chunk
    holds; max_seg: the longest segment's rows; n: the band's rows."""

    band: torch.Tensor
    order: torch.Tensor
    seg_len: torch.Tensor
    chunks: torch.Tensor
    rows: int
    max_seg: int
    n: int

    @property
    def bw(self) -> int:
        return self.band.shape[1] - 1

    @property
    def n_segments(self) -> int:
        return self.seg_len.shape[0]


def segment_bounds(lo: np.ndarray, hi: np.ndarray, n: int) -> np.ndarray:
    """The independent segments of a symmetric pattern of n rows in band
    order, from its entries' lower and higher index (``lo`` <= ``hi``):
    (S + 1,) int64 boundaries, 0 first and n last, at every cut, a position
    c that no entry crosses (lo < c <= hi)."""
    reach = np.arange(n)
    np.maximum.at(reach, np.asarray(lo, np.int64), np.asarray(hi, np.int64))
    cuts = np.flatnonzero(np.maximum.accumulate(reach)[:-1] == np.arange(n - 1)) + 1
    return np.r_[0, cuts, n].astype(np.int64)


def segment_chunk_rows(bw: int) -> int:
    """The rows a CTA of the segments kernel stages at bandwidth ``bw``: an
    f64 solution entry, bw + 1 f32 factor entries and an int32 order entry
    each, in SEG_SMEM."""
    return SEG_SMEM // (8 + 4 * (bw + 1) + 4)


def segment_chunks(seg_len: np.ndarray, bw: int) -> np.ndarray:
    """The chunks of segments of ``seg_len`` rows (longest first): (C + 1,
    2) int64, as ``SegmentBand.chunks``. A chunk takes the next segment
    while it holds fewer than SEG_THREADS and its padded rows stay within
    SEG_ROWS and what SEG_SMEM stages at bandwidth ``bw``."""
    cap = min(SEG_ROWS, segment_chunk_rows(bw))
    lens = [int(v) for v in seg_len]
    firsts, rows, first = [0], [0], 0
    for s in range(1, len(lens)):
        if s - first == SEG_THREADS or lens[first] * (s - first + 1) > cap:
            rows.append(rows[-1] + lens[first] * (s - first))
            firsts.append(s)
            first = s
    rows.append(rows[-1] + lens[first] * (len(lens) - first))
    return np.stack([np.r_[firsts, len(lens)], np.asarray(rows)], 1).astype(np.int64)


def _segment_rows(seg_len, chunks):
    """Per segment: its row 0 in the layout and the step between its rows
    (its chunk's segments), as ``chunks`` and ``seg_len`` lay them out."""
    per = chunks[1:, 0] - chunks[:-1, 0]
    chunk = np.repeat(np.arange(len(per)), per)
    return chunks[chunk, 1] + np.arange(len(seg_len)) - chunks[chunk, 0], per[chunk]


def segment_cholesky(seg: np.ndarray, a: np.ndarray, b: np.ndarray, vals: np.ndarray, seg_len: np.ndarray,
                     bw: int, eps: float, diag_mean: float) -> Tuple[np.ndarray, np.ndarray, bool]:
    """The Cholesky factor of AA^T + eps*scale*I (scale = max(diag_mean, 1),
    as the tile forms' scatter), segment by segment, from AA^T's COO
    entries as (segment, row, column) inside the segments of ``seg_len``
    (longest first): each segment's dense block factored in f64 on the
    host, one batched ``cholesky_ex`` a segment length. Returns (lower,
    inv_diag, ok): per segment row, concatenated in segment order, its
    entries L[i, i-bw..i-1] (zero before the segment) and 1 / L[i, i],
    both f64; ok False where a block did not factor or the factor is not
    finite."""
    starts = np.r_[0, np.cumsum(seg_len)]
    by_seg = np.argsort(seg, kind="stable")
    seg, a, b, v = seg[by_seg], a[by_seg], b[by_seg], np.asarray(vals, np.float64)[by_seg]
    scale = max(float(diag_mean), 1.0)
    lower = np.zeros((int(starts[-1]), bw))
    inv_diag = np.zeros(int(starts[-1]))
    ok = True
    for m in np.unique(seg_len):  # the segments of one length are consecutive (longest first)
        s0, s1 = np.flatnonzero(seg_len == m)[[0, -1]]
        e0, e1 = np.searchsorted(seg, [s0, s1 + 1])
        dense = np.zeros((s1 + 1 - s0, m, m))
        np.add.at(dense, (seg[e0:e1] - s0, a[e0:e1], b[e0:e1]), v[e0:e1])
        diag = np.arange(m)
        dense[:, diag, diag] += eps * scale
        fac, info = torch.linalg.cholesky_ex(torch.from_numpy(dense))
        fac = fac.numpy()
        ok = ok and not info.any() and bool(np.isfinite(fac).all())
        q = slice(int(starts[s0]), int(starts[s1 + 1]))
        inv_diag[q] = (1.0 / fac[:, diag, diag]).reshape(-1)
        blk = lower[q].reshape(-1, m, bw) if bw else None
        for k in range(1, min(bw, m - 1) + 1):
            blk[:, k:, bw - k] = fac[:, diag[k:], diag[:-k]]
    return lower, inv_diag, ok


def segment_band(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, bounds: np.ndarray, bw: int,
                 solver_row: np.ndarray, eps: float, diag_mean: float, device=None) -> Tuple[SegmentBand, bool]:
    """K3's segments form of AA^T + eps*scale*I on ``device``, from AA^T's
    COO entries in band order (bandwidth ``bw``), its segments ``bounds``
    (``segment_bounds``) and the solver row of each band row: the segments
    longest first (a stable sort), their chunks (``segment_chunks``) and
    the factor (``segment_cholesky``) rounded to f32
    once into the layout; the factor's ok beside it."""
    lens = np.diff(bounds)
    segs = np.argsort(-lens, kind="stable")
    seg_len = lens[segs]
    rank = np.empty_like(segs)
    rank[segs] = np.arange(len(segs))
    band_seg = np.repeat(np.arange(len(lens)), lens)  # each band row's segment, in band order
    local = np.arange(bounds[-1]) - bounds[band_seg]
    lower, inv_diag, ok = segment_cholesky(rank[band_seg[rows]], local[rows], local[cols], vals, seg_len, bw, eps,
                                           diag_mean)
    chunks = segment_chunks(seg_len, bw)
    first, step = _segment_rows(seg_len, chunks)
    s = rank[band_seg]
    at = first[s] + local * step[s]  # each band row's row in the layout
    contiguous = np.r_[0, np.cumsum(seg_len)][s] + local  # and in segment_cholesky's order
    band = np.zeros((int(chunks[-1, 1]), bw + 1), np.float32)
    band[at, :bw] = lower[contiguous]
    band[at, bw] = inv_diag[contiguous]
    order = np.full(len(band), -1, np.int64)
    order[at] = solver_row
    as_i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    seg = SegmentBand(band=torch.as_tensor(band, device=device), order=as_i32(order), seg_len=as_i32(seg_len),
                      chunks=as_i32(chunks), rows=int(np.diff(chunks[:, 1]).max()), max_seg=int(seg_len[0]),
                      n=int(bounds[-1]))
    return seg, ok


def band_segments_solve_ref(seg: SegmentBand, r: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's segments form: y = (L L^T)^{-1} r over ``seg``,
    r and y (..., n) in the solver's order; in f64 whatever r's dtype, y in
    r's dtype. Vectorised over the segments: step j solves row j of every
    segment longer than j, forward, then backward; each row's terms are
    taken oldest first, as the kernel takes them."""
    bw, n = seg.bw, r.shape[-1]
    seg_len, chunks = seg.seg_len.cpu().numpy().astype(np.int64), seg.chunks.cpu().numpy().astype(np.int64)
    first, step = (torch.as_tensor(v, device=r.device) for v in _segment_rows(seg_len, chunks))
    lower = seg.band.to(torch.float64)
    live = seg.order >= 0
    solver_row = seg.order[live].long()
    x = torch.zeros(r.shape[:-1] + (seg.band.shape[0],), dtype=torch.float64, device=r.device)
    x[..., live] = r[..., solver_row].to(torch.float64)
    longer = [int((seg_len > j).sum()) for j in range(seg.max_seg)] + [0] * (bw + 1)  # segments longer than j
    for j in range(seg.max_seg):
        q, d = first[: longer[j]] + j * step[: longer[j]], step[: longer[j]]
        acc = x[..., q]
        for k in range(min(j, bw), 0, -1):
            acc = acc - lower[q, bw - k] * x[..., q - k * d]
        x[..., q] = acc * lower[q, bw]
    for j in range(seg.max_seg - 1, -1, -1):
        q, d = first[: longer[j]] + j * step[: longer[j]], step[: longer[j]]
        acc = x[..., q]
        for k in range(bw, 0, -1):
            c = longer[j + k]  # the segments holding row j + k
            nxt = q[:c] + k * d[:c]
            acc[..., :c] -= lower[nxt, bw - k] * x[..., nxt]
        x[..., q] = acc * lower[q, bw]
    y = torch.empty_like(r)
    y[..., solver_row] = x[..., live].to(r.dtype)
    return y


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
        lib.cuadmm_tri_segments.argtypes = [P, I, P, P, I, P, P, P, I, I, P]
        lib.cuadmm_tri_segments.restype = I
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


def band_segments_solve(seg: SegmentBand, r: torch.Tensor) -> torch.Tensor:
    """y = (L L^T)^{-1} r in K3's segments form (``SegmentBand``), r and y in
    the solver's order, of length n, f64 or f32. On CUDA one launch of the
    segments kernel (csrc/tri_stream.cu) reads r through ``seg.order``,
    solves each segment in one thread in f64 and writes y through it, in
    r's dtype, queued on the current stream without synchronizing; on the
    CPU the plain version, ``band_segments_solve_ref``."""
    if r.dim() != 1 or r.shape[0] != seg.n:
        raise ValueError(f"need r of length n={seg.n}, got {tuple(r.shape)}")
    if r.device != seg.band.device:
        raise ValueError(f"band on {seg.band.device} but r on {r.device}")
    if r.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"r must be float32 or float64, got {r.dtype}")
    if r.device.type == "cpu":
        return band_segments_solve_ref(seg, r)
    if r.device.type != "cuda":
        raise ValueError(f"unsupported device {r.device}")
    lib = _load()
    r = r.contiguous()
    y = torch.empty_like(r)
    idx = r.device.index if r.device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        err = lib.cuadmm_tri_segments(
            seg.band.data_ptr(), seg.bw, seg.seg_len.data_ptr(), seg.chunks.data_ptr(), seg.chunks.shape[0] - 1,
            seg.order.data_ptr(), r.data_ptr(), y.data_ptr(), int(r.dtype == torch.float64), seg.rows,
            torch.cuda.current_stream(idx).cuda_stream,
        )
    _check(lib, err, "band_segments_solve launch")
    trace.COUNTS[COUNTER["band_segments_solve"]] += 1
    return y
