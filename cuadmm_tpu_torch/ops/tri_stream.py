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

from cuadmm_tpu_torch import _build
from cuadmm_tpu_torch.ops import launches
from cuadmm_tpu_torch.ops.limits import BAND_MODEL

UPDATE_CHUNK = 64  # panel outer products per _pair_chunk_step

# Each wrapper's entry in ops/launches.py (a call queues the forward and
# the backward sweep of csrc/tri_stream.cu, one persistent launch each).
COUNTER = {"packed_solve": "k2", "band_solve": "k3"}

_LIB = None  # the loaded kernel library, built on the first CUDA launch
_CTAS: dict = {}  # (device index, block) -> co-resident CTAs of one sweep
_STEPS: dict = {}  # (layout, device) -> work tables and tagged scratch of both sweeps


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
    ``ops/limits.py::BAND_MODEL``); the first B wins a tie."""
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


SLAB = 8  # output entries per work item (csrc/tri_stream.cu kSlab)


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


def _device_steps(lay, device: torch.device) -> dict:
    """Both sweeps' work tables on ``device`` (built once per layout), the
    tagged scratch they share (solved vector and partial rows, 64-bit words
    {value, epoch}), and the device word holding the next sweep's epoch
    (the kernel advances it after each sweep, so a CUDA graph replaying a
    solve tags each replay anew)."""
    key = (type(lay).__name__, tuple(lay), str(device))
    if key not in _STEPS:
        sweeps, rows = [], 1
        for table, transpose in zip(_sweep_tables(lay), (False, True)):
            items, steps, row_blk = _work_table(_steps(table, transpose), lay.block)
            rows = max(rows, len(row_blk))
            sweeps.append(dict(items=torch.as_tensor(items, device=device), n_items=len(items),
                               steps=torch.as_tensor(steps, device=device),
                               row_blk=torch.as_tensor(np.r_[row_blk, 0].astype(np.int32), device=device)))
        _STEPS[key] = dict(
            sweeps=sweeps,
            solved=torch.zeros(lay.n_pad, dtype=torch.int64, device=device),
            parts=torch.zeros(rows * lay.block, dtype=torch.int64, device=device),
            epoch=torch.ones(1, dtype=torch.int32, device=device),  # read as unsigned; fresh scratch tags 0
        )
    return _STEPS[key]


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.cuadmm_cuda_error_string(err).decode()
        raise RuntimeError(f"tri_stream {what} failed: {msg} (cudaError {err})")


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("tri_stream")
        for fn in (lib.cuadmm_tri_stream_fwd, lib.cuadmm_tri_stream_bwd):
            fn.argtypes = (
                [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                + [ctypes.c_void_p] * 6
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            )
            fn.restype = ctypes.c_int
        lib.cuadmm_tri_stream_capacity.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.cuadmm_tri_stream_capacity.restype = ctypes.c_int
        lib.cuadmm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuadmm_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _capacity(lib: ctypes.CDLL, idx: int, B: int) -> int:
    """Co-resident CTAs of one sweep on device ``idx`` at block B (cached)."""
    if (idx, B) not in _CTAS:
        n = ctypes.c_int(0)
        _check(lib, lib.cuadmm_tri_stream_capacity(B, ctypes.byref(n)), "occupancy query")
        _CTAS[(idx, B)] = n.value
    return _CTAS[(idx, B)]


def _solve(tiles: torch.Tensor, r: torch.Tensor, lay, name: str) -> torch.Tensor:
    B = lay.block
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (B, B) or tiles.shape[0] < lay.T:
        raise ValueError(f"need tiles (>= {lay.T}, {B}, {B}), got {tuple(tiles.shape)}")
    if r.dim() != 1 or r.shape[0] > lay.n_pad:
        raise ValueError(f"need r of length <= n_pad={lay.n_pad}, got {tuple(r.shape)}")
    if tiles.device != r.device:
        raise ValueError(f"tiles on {tiles.device} but r on {r.device}")
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
    lib = _load()
    dev = tiles.device
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        ctas = _capacity(lib, idx, B)
        tab = _device_steps(lay, dev)
        rp = torch.nn.functional.pad(r.to(torch.float32), (0, lay.n_pad - r.shape[0])).contiguous()
        x = torch.empty(lay.n_pad, dtype=torch.float32, device=dev)
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(idx).cuda_stream
        fns = (lib.cuadmm_tri_stream_fwd, lib.cuadmm_tri_stream_bwd)
        for fn, sw, rhs, out in zip(fns, tab["sweeps"], (rp, x), (x, y)):
            # Each launched sweep reads the epoch from its device word and
            # advances it after itself (wrapping past 0 after 2^32 sweeps),
            # so the scratch never needs a reset.
            err = fn(
                tiles.data_ptr(), B, sw["items"].data_ptr(), sw["n_items"], sw["steps"].data_ptr(),
                sw["row_blk"].data_ptr(), rhs.data_ptr(), out.data_ptr(), tab["solved"].data_ptr(),
                tab["parts"].data_ptr(), tab["epoch"].data_ptr(), ctas, stream,
            )
            _check(lib, err, f"{name} launch")
    launches.LAUNCHES[COUNTER[name]] += 1
    return y[: r.shape[0]].to(r.dtype)


def packed_solve(tiles: torch.Tensor, r: torch.Tensor, lay: PackedLayout) -> torch.Tensor:
    """y = (L L^T)^{-1} r over packed tiles (K2). ``r`` has at most n_pad
    entries (zero-padded to n_pad); y has r's length and dtype. On CUDA the
    tiles must be float32 and the kernel is queued on the current stream
    without synchronizing."""
    return _solve(tiles, r, lay, "packed_solve")


def band_solve(tiles: torch.Tensor, r: torch.Tensor, lay: BandLayout) -> torch.Tensor:
    """y = (L L^T)^{-1} r over band tiles (K3); the contract of
    ``packed_solve``."""
    return _solve(tiles, r, lay, "band_solve")
