"""Normal-equation solver for (A A^T) y = rhs: precond, packed and banded.

Port of those three modes of cuadmm_tpu/ops/chol.py. At init, AA^T plus a
relative diagonal regularization eps is factorized once in f32 on the
device (eps escalates x10 until the factor is good). Each solve runs
``applies`` refinement sweeps

    y <- y + P^{-1} (rhs - A (A^T y))

with the residual accumulated in f64 through the exact sparse A and
P^{-1} r applied from the f32 factor (``NormalEqSolver._apply_factor``):

- ``precond`` (con_num <= dense_chol_max): the triangular factor inverted
  explicitly and zero-padded, M = inv(L); M^T M r by the fused kernel K1
  (ops/precond_apply.py).
- ``packed``: the factor's lower triangle as packed B x B tiles with
  inverted diagonal tiles (ops/tri_stream.py); a forward and a backward
  streaming sweep by K2.
- ``banded``: the same over the block band of AA^T under a reverse
  Cuthill-McKee permutation; the residual is gathered into that order, K3
  sweeps the band, and the result is gathered back.

The rhs of every ADMM solve lies in range(A), so each sweep contracts the
residual by about eps even where AA^T is numerically singular.

The JAX package takes these f32 routes only on an accelerator (on the CPU
it keeps the factor in the state dtype); the port takes them on every
device, so the CPU tests run the card's code except the kernels. ``auto``
resolves as the JAX package does, on the CPU as there. The other modes are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch.device import synchronize
from cuadmm_tpu_torch.ops import tri_stream
from cuadmm_tpu_torch.ops.precond_apply import fused_spd_apply, pad_factor
from cuadmm_tpu_torch.ops.sparse import SparseA, aat_matvec

_NOT_PORTED = {
    "dense": "Normal solver: dense and split modes",
    "split": "Normal solver: dense and split modes",
    "sharded": "Several devices",
    "cg": "CG, FSAI, block-Jacobi and host modes",
    "host": "CG, FSAI, block-Jacobi and host modes",
}


def _not_ported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"normal_solver={mode!r} is not ported yet (ROADMAP.md queue 1: "
        f"{_NOT_PORTED[mode]!r}); the port has normal_solver 'precond', 'packed' and 'banded'"
    )


# Calibration of the sweep count: the relative residual the f64 refinement
# must beat, and the most sweeps tried.
CALIBRATE_TARGET = 1e-10
CALIBRATE_MAX_APPLIES = 6

# The JAX package's thresholds past dense_chol_max (cuadmm_tpu/ops/chol.py:
# 99-109), sized there for a 16 GB chip and kept so that ``auto`` picks what
# the JAX package picks. Largest con_num auto routes to the packed factor:
PACKED_MAX_CON = 73_000
# Largest f32 band factor auto places:
BAND_MAX_BYTES = int(14.2 * 2**30)


def _rcm_bandwidth(aat) -> tuple:
    """(bandwidth, permutation) of AA^T under reverse Cuthill-McKee; the
    identity when RCM does not beat the natural ordering."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = aat.tocsr()
    coo = aat.tocoo()
    bw_nat = int(np.abs(coo.row - coo.col).max()) if coo.nnz else 0
    perm = np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
    pinv = np.empty_like(perm)
    pinv[perm] = np.arange(len(perm))
    bw_rcm = int(np.abs(pinv[coo.row] - pinv[coo.col]).max()) if coo.nnz else 0
    if bw_nat <= bw_rcm:
        return bw_nat, np.arange(aat.shape[0])
    return bw_rcm, perm


def past_ceiling_mode(con_num: int, bw: Optional[int], on_accel: bool, n_devices: int = 1) -> str:
    """The mode ``auto`` picks past dense_chol_max (cuadmm_tpu/ops/chol.py:
    802-842). On an accelerator: the packed triangle if it streams at most
    15% more bytes than the band factor at RCM bandwidth ``bw``, else the
    band if it fits BAND_MAX_BYTES, else packed if con_num allows, else
    sharded over several devices, else cg. Off an accelerator: cg."""
    if not on_accel:
        return "cg"
    blay = tri_stream.make_band_layout(con_num, bw)
    band_bytes = blay.T * blay.block * blay.block * 4
    packed_bytes = (
        tri_stream.make_layout(con_num).T * 1024 * 1024 * 4 if con_num <= PACKED_MAX_CON else None
    )
    if packed_bytes is not None and packed_bytes <= band_bytes * 1.15:
        return "packed"
    if band_bytes <= BAND_MAX_BYTES:
        return "banded"
    if packed_bytes is not None:
        return "packed"
    return "sharded" if n_devices > 1 else "cg"


@dataclasses.dataclass
class NormalEqSolver:
    """A factorized AA^T (one of the three factor forms) and the f64 A."""

    mode: str
    sparse_a: SparseA  # f64, for the refinement residuals
    # precond: (n_pad, n_pad) f32, zero-padded inv(L).
    inv_l: Optional[torch.Tensor] = None
    # packed: (T+1, B, B) f32 tiles with inverted diagonal tiles, and the
    # PackedLayout as a tuple.
    packed_tiles: Optional[torch.Tensor] = None
    packed_layout: Optional[tuple] = None
    # banded: (T+1, B, B) f32 band tiles, the BandLayout as a tuple, and the
    # RCM permutation (solver row of each band row) with its inverse; None
    # when the natural order is already the band's.
    band_tiles: Optional[torch.Tensor] = None
    band_layout: Optional[tuple] = None
    band_perm: Optional[torch.Tensor] = None
    band_inv_perm: Optional[torch.Tensor] = None
    applies: int = 2  # refinement sweeps per solve
    eps_used: float = 0.0

    def _residual_buffer(self) -> torch.Tensor:
        """A zeroed f32 buffer of the factor's padded length n_pad, which
        ``_apply_factor`` reads as it is; the sweeps write only its head."""
        if self.inv_l is not None:
            return self.inv_l.new_zeros(self.inv_l.shape[0])
        if self.packed_tiles is not None:
            return self.packed_tiles.new_zeros(tri_stream.PackedLayout(*self.packed_layout).n_pad)
        return self.band_tiles.new_zeros(tri_stream.BandLayout(*self.band_layout).n_pad)

    def _apply_factor(self, r: torch.Tensor) -> torch.Tensor:
        """Approximate P^{-1} r for the f32 residual buffer ``r``; the first
        con_num entries of the result are the answer.

        precond: M^T (M r) by K1. packed: the two streaming sweeps by K2.
        banded: r gathered into the band's order, K3, and gathered back;
        the gathers are skipped when the permutation is the identity."""
        if self.inv_l is not None:
            return fused_spd_apply(self.inv_l, r)
        if self.packed_tiles is not None:
            lay = tri_stream.PackedLayout(*self.packed_layout)
            return tri_stream.packed_solve(self.packed_tiles, r, lay)
        lay = tri_stream.BandLayout(*self.band_layout)
        if self.band_perm is None:
            return tri_stream.band_solve(self.band_tiles, r, lay)
        n = self.band_perm.shape[0]
        return tri_stream.band_solve(self.band_tiles, r[:n][self.band_perm], lay)[self.band_inv_perm]

    def _sweep(self, rhs: torch.Tensor, y: torch.Tensor, r_pad: torch.Tensor) -> torch.Tensor:
        """One refinement sweep: y + P^{-1} (rhs - AA^T y), in f64 but for
        the factor.

        ``r_pad`` is the ``_residual_buffer``: the f64 residual is rounded
        into its head in one kernel, the factor reads the buffer as it is,
        and its f32 result is added to the f64 y in one more. P^{-1}
        approximates (AA^T + eps I)^{-1} with error ~ cond(L) * eps32,
        which the sweeps contract against the exact AA^T.
        """
        n = y.shape[0]
        torch.sub(rhs, aat_matvec(self.sparse_a, y), out=r_pad[:n])
        return y + self._apply_factor(r_pad)[:n]

    def solve(self, rhs: torch.Tensor, warm: Optional[torch.Tensor] = None) -> torch.Tensor:
        # Refinement through the composed A (A^T y): its rounding stays in
        # range(A), which the regularized factor does not amplify.
        hp = torch.float64
        rhs_hp = rhs.to(hp)
        y = torch.zeros_like(rhs_hp) if warm is None else warm.to(hp)
        r_pad = self._residual_buffer()
        for _ in range(self.applies):
            y = self._sweep(rhs_hp, y, r_pad)
        return y.to(rhs.dtype)

    def residual_norm(self, rhs: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """|| rhs - AA^T y || / || rhs ||, in f64."""
        rhs = rhs.to(torch.float64)
        r = rhs - aat_matvec(self.sparse_a, y.to(torch.float64))
        return torch.linalg.norm(r) / torch.linalg.norm(rhs)


def build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len) -> sp.csr_matrix:
    """Host-side sparse AA^T (con_num x con_num) from A^T triplets."""
    a = sp.csr_matrix((vals, (at_con_idx, at_svec_idx)), shape=(con_num, vec_len))
    return (a @ a.T).tocsr()


def _device_factorize(
    at_svec_idx,
    at_con_idx,
    vals,
    con_num: int,
    vec_len: int,
    eps: float,
    device: torch.device,
    dense_a_build_limit: int = 6 * 1024**3,
):
    """f32 Cholesky factor of AA^T + eps*scale*I on ``device``.

    Scatters A dense on the device (duplicate COO entries add) and forms
    AA^T with one f32 matmul; past ``dense_a_build_limit`` bytes of dense A
    the sparse product is formed on the host and shipped dense instead.
    ``eps`` escalates x10 until the factor is finite: plain Cholesky needs
    the diagonal safely positive on a semidefinite AA^T. Returns (L, eps).
    """
    f32 = torch.float32
    if con_num * vec_len * 4 <= dense_a_build_limit:
        rows = torch.as_tensor(np.asarray(at_con_idx, np.int64), device=device)
        cols = torch.as_tensor(np.asarray(at_svec_idx, np.int64), device=device)
        v = torch.as_tensor(np.asarray(vals, np.float32), device=device)
        a = torch.zeros((con_num, vec_len), dtype=f32, device=device)
        a.index_put_((rows, cols), v, accumulate=True)
        aat = a @ a.T
        del a
        scale = torch.clamp(torch.trace(aat) / con_num, min=1.0)
    else:
        aat_host = build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        aat = torch.as_tensor(np.asarray(aat_host.todense(), np.float32), device=device)
        scale = float(max(aat_host.diagonal().sum() / con_num, 1.0))
    cur = float(eps)
    while True:
        reg = aat.clone()
        reg.diagonal().add_(cur * scale)
        l, info = torch.linalg.cholesky_ex(reg)
        del reg
        # cholesky_ex reports failure in ``info`` instead of raising.
        if int(info) == 0 and bool(torch.isfinite(l[-1, -1])):
            return l, cur
        cur *= 10.0
        if cur > 1e-1:
            raise RuntimeError("AA^T Cholesky failed even with jitter 1e-1")


def _tile_factorize(scatter: Callable, factor: Callable, last_tile: int, eps: float, what: str):
    """Scatter and factor tiles with jitter eps, x10 until every diagonal
    tile factored (``factor``'s device status) and the last diagonal entry
    is finite: both read in one device wait. Returns (tiles, eps)."""
    cur = float(eps)
    while True:
        tiles = scatter(cur)
        status = factor(tiles)
        if bool((status == 0) & torch.isfinite(tiles[last_tile, -1, -1])):
            return tiles, cur
        del tiles
        cur *= 10.0
        if cur > 1e-1:
            raise RuntimeError(f"{what} AA^T Cholesky failed even with jitter 1e-1")


def _tri_inv(l: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a lower-triangular factor.

    Error ~ cond(L) * eps = sqrt(cond(P)) * eps, enough for a refined
    preconditioner. The JAX package blocks this by hand only to dodge an
    XLA temporary blow-up on a 16 GB chip; a triangular solve against the
    identity needs two n^2 f32 buffers (8.6 GB at dense_chol_max = 32768),
    which the H100's 80 GB holds.
    """
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def _calibrate_applies(neq: NormalEqSolver, con_num: int) -> NormalEqSolver:
    """Pick the refinement sweep count on the device that will run it.

    Runs the real solve path on a consistent probe rhs = (AA^T) v and takes
    the smallest sweep count whose relative residual beats
    ``CALIBRATE_TARGET``. Doubles as a factor sanity probe: raises if even
    ``CALIBRATE_MAX_APPLIES`` sweeps cannot reach 1e-2.
    """
    sa = neq.sparse_a
    r_pad = neq._residual_buffer()
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(con_num), dtype=torch.float64, device=r_pad.device)
    rhs = aat_matvec(sa, v)
    y = torch.zeros_like(rhs)
    resids = []
    for _ in range(CALIBRATE_MAX_APPLIES):
        y = neq._sweep(rhs, y, r_pad)
        resids.append(torch.linalg.norm(rhs - aat_matvec(sa, y)))
    curve = (torch.stack(resids) / torch.linalg.norm(rhs)).cpu().numpy()
    ok = np.isfinite(curve) & (curve < CALIBRATE_TARGET)
    if ok.any():
        return dataclasses.replace(neq, applies=int(np.argmax(ok)) + 1)
    best = int(np.nanargmin(curve)) if np.isfinite(curve).any() else CALIBRATE_MAX_APPLIES - 1
    if not np.isfinite(curve[best]) or curve[best] > 1e-2:
        raise RuntimeError(
            f"normal-equation factor failed the on-device probe: relative "
            f"residual curve {curve} (eps_used={neq.eps_used:g}). The "
            "factorization is unusable; try a larger precond_eps."
        )
    return dataclasses.replace(neq, applies=best + 1)


def _resolve_auto(at_svec_idx, at_con_idx, vals, con_num, vec_len, dtype, on_accel, dense_chol_max):
    """``auto`` as the JAX package resolves it (cuadmm_tpu/ops/chol.py:
    781-847). Returns (mode, AA^T on the host or None, RCM probe or None);
    the last two are only computed past dense_chol_max on an accelerator."""
    cpu_max_factor_bytes = 2**31 - 1
    # Coupled rows: constraints sharing an svec column with another.
    col_mult = np.bincount(at_svec_idx, minlength=vec_len)
    shared = col_mult[at_svec_idx] >= 2
    n_coupled = len(np.unique(at_con_idx[shared]))
    split_fits_cpu = on_accel or n_coupled * n_coupled * 4 <= cpu_max_factor_bytes
    aat = band_probe = None
    if n_coupled <= min(dense_chol_max, max(con_num // 2, 1024)) and split_fits_cpu:
        mode = "split"
    elif con_num <= dense_chol_max:
        mode = "precond" if (on_accel or dtype == torch.float32) else "dense"
    else:
        if on_accel:
            aat = build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
            band_probe = _rcm_bandwidth(aat)
        mode = past_ceiling_mode(con_num, band_probe[0] if band_probe else None, on_accel)
    if not on_accel:  # the JAX package's CPU factor-size guards
        if mode == "dense" and con_num * con_num * 8 > cpu_max_factor_bytes:
            mode = "precond"
        if mode == "precond" and con_num * con_num * 4 > cpu_max_factor_bytes:
            mode = "cg"
    return mode, aat, band_probe


def build_normal_solver(
    at_svec_idx: np.ndarray,
    at_con_idx: np.ndarray,
    vals: np.ndarray,
    con_num: int,
    vec_len: int,
    sparse_a: SparseA,
    mode: str,
    dtype: torch.dtype,
    device: torch.device,
    dense_chol_max: int = 32768,
    precond_eps: float = 1e-4,
    applies: int = 2,
    timings: Optional[Dict[str, object]] = None,
) -> NormalEqSolver:
    """Factorize once at init and return a device-resident solver.

    ``mode="auto"`` resolves as the JAX package does on the device's kind
    (``_resolve_auto``); ``precond``, ``packed`` and ``banded`` build, every
    other mode raises ``NotImplementedError``. ``sparse_a`` is the f64 A of
    the refinement. ``timings``, when given, receives the wall seconds of
    each stage (and, for banded, the bandwidth and layout).
    """
    on_accel = device.type == "cuda"
    if mode == "inv":  # legacy alias
        mode = "precond"
    aat = band_probe = None
    if mode == "auto":
        mode, aat, band_probe = _resolve_auto(
            at_svec_idx, at_con_idx, vals, con_num, vec_len, dtype, on_accel, dense_chol_max
        )
    if mode in _NOT_PORTED:
        raise _not_ported(mode)
    if mode not in ("precond", "packed", "banded"):
        raise ValueError(f"unknown normal_solver {mode!r}")
    if mode == "precond" and con_num > dense_chol_max:
        raise ValueError(
            f"normal_solver='precond' needs con_num <= dense_chol_max={dense_chol_max}, "
            f"got {con_num}"
        )

    t = [time.perf_counter()]

    def mark(name: str) -> None:
        synchronize(device)
        now = time.perf_counter()
        if timings is not None:
            timings[name] = round(now - t[0], 3)
        t[0] = now

    f32 = torch.float32
    applies_0 = max(applies, 1)
    if mode == "precond":
        l, eps_used = _device_factorize(
            at_svec_idx, at_con_idx, vals, con_num, vec_len, max(precond_eps, 1e-5), device
        )
        mark("factorize")
        inv_l = pad_factor(_tri_inv(l))
        del l  # only the inverse is kept: frees n^2 of device memory
        mark("tri_inv")
        neq = NormalEqSolver(
            mode="precond", sparse_a=sparse_a, inv_l=inv_l, applies=applies_0, eps_used=eps_used
        )
    else:
        if aat is None:
            aat = build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        coo = aat.tocoo()
        diag_mean = float(aat.diagonal().mean())
        if mode == "packed":
            lay = tri_stream.make_layout(con_num, 1024 if con_num > 2048 else 256)
            rows, cols = coo.row.astype(np.int64), coo.col.astype(np.int64)
            tiles, eps_used = _tile_factorize(
                lambda e: tri_stream.scatter_packed_aat(rows, cols, coo.data, lay, e, diag_mean, f32, device),
                lambda tl: tri_stream.packed_cholesky(tl, lay),
                tri_stream.tid(lay.nb - 1, lay.nb - 1),
                max(precond_eps, 1e-5),
                "packed",
            )
            mark("packed_factorize")
            neq = NormalEqSolver(
                mode="packed", sparse_a=sparse_a, packed_tiles=tiles, packed_layout=tuple(lay),
                applies=applies_0, eps_used=eps_used,
            )
        else:
            bw, perm = band_probe if band_probe is not None else _rcm_bandwidth(aat)
            pinv = np.empty_like(perm)
            pinv[perm] = np.arange(con_num)
            lay = tri_stream.make_band_layout(con_num, bw)
            rows, cols = pinv[coo.row].astype(np.int64), pinv[coo.col].astype(np.int64)
            # The jitter ladder starts at 1e-5 rather than precond_eps: a
            # band factors fine there, and the looser 1e-4 costs a sweep.
            tiles, eps_used = _tile_factorize(
                lambda e: tri_stream.scatter_band_aat(rows, cols, coo.data, lay, e, diag_mean, f32, device),
                lambda tl: tri_stream.band_cholesky(tl, lay),
                tri_stream.tid_band(lay.nb - 1, lay.nb - 1, lay),
                max(min(precond_eps, 1e-5), 1e-7),
                "band",
            )
            mark("band_factorize")
            if timings is not None:
                timings["band_bw"] = int(bw)
                timings["band_layout"] = (
                    f"nb={lay.nb} nbw={lay.nbw} B={lay.block} bytes={lay.T * lay.block * lay.block * 4}"
                )
            identity = bool(np.array_equal(perm, np.arange(con_num)))
            as_idx = lambda p: torch.as_tensor(np.asarray(p, np.int64), device=device)
            neq = NormalEqSolver(
                mode="banded", sparse_a=sparse_a, band_tiles=tiles, band_layout=tuple(lay),
                band_perm=None if identity else as_idx(perm),
                band_inv_perm=None if identity else as_idx(pinv),
                applies=applies_0, eps_used=eps_used,
            )
    if applies <= 0:
        neq = _calibrate_applies(neq, con_num)
    mark("calibrate")
    return neq
