"""Normal-equation solver for (A A^T) y = rhs.

Port of cuadmm_tpu/ops/chol.py, every mode. The factor modes factorize
AA^T plus a relative diagonal regularization eps once at init (eps
escalates x10 until the factor is good) and run ``applies`` refinement
sweeps per solve

    y <- y + P^{-1} (rhs - A (A^T y))

with the residual accumulated in f64 through the exact sparse A. The rhs
of every ADMM solve lies in range(A), so each sweep contracts the residual
by about eps even where AA^T is numerically singular. Each mode has one
builder and one class for its factor, which owns the buffer it reads and
its sweep (``NormalEqSolver`` runs the sweeps): ``precond``
(con_num <= dense_chol_max) an ``InverseFactor`` for K1, ``dense`` an f64
``CholFactor``, ``split`` a ``SplitFactor`` (AA^T block-diagonal under
[S, S^c], S the rows that share an svec column with another row),
``packed`` and ``banded`` K2's and K3's tiles (``PackedFactor``,
``BandFactor``; ops/tri_stream.py) or, for a band of short independent
segments, K3's segments form (``SegmentFactor``), ``sharded`` a
``ShardedFactor`` over a rank mesh (parallel/tri_shard.py). ``cg`` and
``host`` have no factor and no sweeps: ``CGSolver`` (preconditioned CG in f64 over an ELL table
of AA^T, preconditioned by FSAI (ops/fsai.py), block-Jacobi or Jacobi)
and ``HostSolver`` (a scipy sparse LU of AA^T + eps I on the host).

The JAX package takes the f32 routes only on an accelerator (on the CPU it
keeps precond's and split's factors in the state dtype); the port takes
them on every device, so the CPU tests run the card's code except the
kernels. ``auto`` resolves by the JAX package's rule, on the CPU as there;
on CUDA the numbers that rule reads past dense_chol_max (the packed and
band ceilings, the band's block) are the card's own (ops/limits.py), as
are the dense-A budget and the inverse factor's largest n_pad.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.ops import limits as lim
from cuadmm_tpu_torch.ops import tri_stream
from cuadmm_tpu_torch.ops.fsai import build_fsai, fsai_tables
from cuadmm_tpu_torch.ops.limits import CardLimits, card_limits
from cuadmm_tpu_torch.ops.precond_apply import LANE, fused_spd_apply, pad_factor
from cuadmm_tpu_torch.ops.sparse import EllTable, SparseA, _build_ell, _ell_matvec, aat_matvec
from cuadmm_tpu_torch.parallel import tri_shard
from cuadmm_tpu_torch.parallel.mesh import Mesh


# Calibration of the sweep count: the relative residual the f64 refinement
# must beat unless the caller passes a target (the f32 driver does), and
# the most sweeps tried.
CALIBRATE_TARGET = 1e-10
CALIBRATE_MAX_APPLIES = 6

# CG steps queued between two reads of the convergence flag on the host.
CG_BLOCK = 16

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


def chain_tiles(tiles: torch.Tensor, lay: "tri_stream.BandLayout",
                max_bytes: Optional[int] = None) -> Tuple[str, Optional[torch.Tensor]]:
    """K3's form for a factored band on a card whose band may hold
    ``max_bytes`` (``tri_stream.band_form``; None: no limit) and the
    one-hop form's derived tiles (``tri_stream.band_chain``), None in the
    two-hop form."""
    form = tri_stream.band_form(lay, max_bytes)
    return form, tri_stream.band_chain(tiles, lay) if form == "chain" else None


def past_ceiling_mode(con_num: int, bw: Optional[int], on_accel: bool, n_devices: int,
                      limits: Optional[CardLimits]) -> str:
    """The mode ``auto`` picks past dense_chol_max, by the JAX package's rule
    (cuadmm_tpu/ops/chol.py:802-842) over ``limits``' numbers. On an
    accelerator: the packed triangle if it streams at most 15% more bytes
    than the band factor at RCM bandwidth ``bw`` (its block picked by
    ``limits.bound_band_model()``), else the band if its tiles fit
    ``limits.band_max_bytes`` (in the one-hop form where its derived tiles
    fit beside them, ``tri_stream.band_form``), else packed if con_num is within
    ``limits.packed_max_con``, else sharded over ``n_devices`` > 1 ranks,
    else cg. Off an accelerator: cg (``limits`` unread)."""
    if not on_accel:
        return "cg"
    blay = tri_stream.make_band_layout(con_num, bw, model=limits.bound_band_model())
    band_bytes = tri_stream.band_bytes(blay, "two_hop")  # streamed a sweep, in either form
    packed_bytes = (
        tri_stream.make_layout(con_num).T * 1024 * 1024 * 4 if con_num <= limits.packed_max_con else None
    )
    if packed_bytes is not None and packed_bytes <= band_bytes * 1.15:
        return "packed"
    if band_bytes <= limits.band_max_bytes:
        return "banded"
    if packed_bytes is not None:
        return "packed"
    return "sharded" if n_devices > 1 else "cg"


def _pcg(op, rhs, apply_m, x0, tol: float, max_iter: int, block: int = CG_BLOCK):
    """Preconditioned CG on AA^T (cuadmm_tpu/ops/chol.py:446), with
    ``apply_m`` the preconditioner application. Returns (x, steps, waits).

    The JAX loop tests r.r > tol^2 |rhs|^2 on the device before every
    step. Here the steps are queued in blocks of ``block``: each step
    computes its update and keeps it only where that test (and it <
    max_iter) holds, a device select, so once the test fails nothing
    changes and the result is the JAX loop's. The host reads one flag per
    block: ``waits`` is the number of blocks, ``steps`` the steps kept.
    """
    thresh = tol * tol * torch.dot(rhs, rhs)
    x = x0
    r = rhs - op(x0)
    p = apply_m(r)
    rz = torch.dot(r, p)
    it = torch.zeros((), dtype=torch.int64, device=rhs.device)
    waits = 0
    while True:
        for _ in range(block):
            active = (it < max_iter) & (torch.dot(r, r) > thresh)
            ap = op(p)
            alpha = rz / torch.dot(p, ap)
            r_new = r - alpha * ap
            z = apply_m(r_new)
            rz_new = torch.dot(r_new, z)
            x = torch.where(active, x + alpha * p, x)
            p = torch.where(active, z + (rz_new / rz) * p, p)
            r = torch.where(active, r_new, r)
            rz = torch.where(active, rz_new, rz)
            it = it + active
        waits += 1
        more = (it < max_iter) & (torch.dot(r, r) > thresh)
        more, steps = torch.stack([more.to(it.dtype), it]).tolist()
        if not more:
            return x, steps, waits


def _each(fn: Callable, x: torch.Tensor, *rest) -> torch.Tensor:
    """``fn`` on one right-hand side ``x``, or on each instance of a batch
    (B, ·) with the matching rows of ``rest`` (batched like ``x``, or None),
    stacked: the one batch loop, for factors of one right-hand side, cg, host."""
    if x.dim() == 1:
        return fn(x, *rest)
    rest = [[None] * len(x) if a is None else a for a in rest]
    return torch.stack([fn(*args) for args in zip(x, *rest)])


class _Factor:
    """What the sweeps apply: ``buffer(lead)`` the zeroed f32 (*lead, n_pad)
    buffer an f32 factor reads (None for an f64 one), ``sweep`` one sweep
    y + P^{-1} (rhs - AA^T y), in f64 but for an f32 factor (here an f64
    factor's: P^{-1} by its ``apply_head``). A CUDA graph holds every
    factor's solve (``eager`` None)."""

    sweeps = True
    eager = None

    def buffer(self, lead: tuple = ()) -> Optional[torch.Tensor]:
        return None

    def sweep(self, sparse_a: SparseA, rhs: torch.Tensor, y: torch.Tensor, buf: None) -> torch.Tensor:
        return y + self.apply_head(rhs - aat_matvec(sparse_a, y))


class _PaddedFactor(_Factor):
    """An f32 factor over every row: the f64 residual is rounded into the
    buffer's head in one kernel, ``apply`` reads the buffer as it is, and
    its f32 result's head is added to the f64 y in one more. The sweeps
    contract P^{-1}'s error, ~ cond(L) * eps32, against the exact AA^T."""

    def sweep(self, sparse_a: SparseA, rhs: torch.Tensor, y: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
        n = y.shape[-1]
        torch.sub(rhs, aat_matvec(sparse_a, y), out=buf[..., :n])
        return y + self.apply(buf)[..., :n]


@dataclasses.dataclass
class InverseFactor(_PaddedFactor):
    """precond's, and split's f32 prefix: (n_pad, n_pad) zero-padded inv(L),
    exactly zero above the diagonal (``pad_factor``). M^T (M r) by K1, one
    read of the factor for up to 8 of a batch's right-hand sides."""

    inv_l: torch.Tensor

    def buffer(self, lead: tuple = ()) -> torch.Tensor:
        return self.inv_l.new_zeros(lead + (self.inv_l.shape[0],))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return fused_spd_apply(self.inv_l, r)

    def apply_head(self, r: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
        p = r.shape[-1]
        buf[..., :p] = r
        return self.apply(buf)[..., :p]


@dataclasses.dataclass
class CholFactor(_Factor):
    """dense's f64 lower factor, and split's prefix carried over from an f64
    JAX build: one cholesky_solve an instance (a batched one takes MAGMA's
    batched solve on CUDA, which a CUDA graph cannot capture)."""

    chol_l: torch.Tensor

    def apply_head(self, r: torch.Tensor, buf: None = None) -> torch.Tensor:
        return _each(lambda v: torch.cholesky_solve(v.unsqueeze(-1), self.chol_l).squeeze(-1), r)


@dataclasses.dataclass
class PackedFactor(_PaddedFactor):
    """packed: (T+1, B, B) f32 tiles with inverted diagonal tiles; the two
    streaming sweeps by K2."""

    tiles: torch.Tensor
    layout: tri_stream.PackedLayout

    def buffer(self, lead: tuple = ()) -> torch.Tensor:
        return self.tiles.new_zeros(lead + (self.layout.n_pad,))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return _each(lambda v: tri_stream.packed_solve(self.tiles, v, self.layout), r)


@dataclasses.dataclass
class BandFactor(_PaddedFactor):
    """banded: (T+1, B, B) f32 band tiles, K3's form (``chain_tiles``) with
    the one-hop form's derived tiles, and the RCM permutation (solver row
    of each band row) with its inverse, None when the natural order is
    already the band's (else r is gathered in and out of it)."""

    tiles: torch.Tensor
    layout: tri_stream.BandLayout
    form: str
    chain: Optional[torch.Tensor]
    perm: Optional[torch.Tensor] = None
    inv_perm: Optional[torch.Tensor] = None

    def buffer(self, lead: tuple = ()) -> torch.Tensor:
        return self.tiles.new_zeros(lead + (self.layout.n_pad,))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return _each(self._apply_one, r)

    def _apply_one(self, r: torch.Tensor) -> torch.Tensor:
        if self.perm is not None:
            r = r[: self.perm.shape[0]][self.perm]
        y = tri_stream.band_solve(self.tiles, r, self.layout, chain=self.chain, form=self.form)
        return y if self.inv_perm is None else y[self.inv_perm]


@dataclasses.dataclass
class SegmentFactor(_Factor):
    """banded, K3's segments form: the band's independent segments, each
    factored on its own, no tile (``tri_stream.SegmentBand``). The sweep's
    f64 residual goes to the kernel as it is, through the order the
    segments carry, and its f64 answer comes back."""

    segments: tri_stream.SegmentBand

    def apply_head(self, r: torch.Tensor, buf: None = None) -> torch.Tensor:
        return _each(lambda v: tri_stream.band_segments_solve(self.segments, v), r)


@dataclasses.dataclass
class ShardedFactor(_PaddedFactor):
    """sharded: this rank's (nb, ncl, B, B) f32 column slab of the factor
    grid and the mesh its distributed sweeps run over, r padded to the
    grid's n_pad (cuadmm_tpu/ops/chol.py:257-266)."""

    grid: torch.Tensor
    mesh: Mesh

    def buffer(self, lead: tuple = ()) -> torch.Tensor:
        nb, _, B, _ = self.grid.shape
        return self.grid.new_zeros(lead + (nb * B,))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return _each(lambda v: tri_shard.sharded_tri_solve(self.grid, v, self.mesh), r)


@dataclasses.dataclass
class SplitFactor(_Factor):
    """split: the p coupled rows' factor (None when p = 0), the f64 inverse
    diagonal of the others, and the permutation [S, S^c] with its inverse,
    None when S is already the prefix (QUASAR). The update is formed in the
    residual's own storage; only a permutation copies it (two gathers)."""

    prefix: "Optional[InverseFactor | CholFactor]"
    p: int
    tail_inv_diag: torch.Tensor
    perm: Optional[torch.Tensor] = None
    inv_perm: Optional[torch.Tensor] = None

    def buffer(self, lead: tuple = ()) -> Optional[torch.Tensor]:
        return None if self.prefix is None else self.prefix.buffer(lead)

    def sweep(self, sparse_a: SparseA, rhs: torch.Tensor, y: torch.Tensor, buf) -> torch.Tensor:
        r = rhs - aat_matvec(sparse_a, y)
        if self.perm is not None:
            r = r[..., self.perm]
        r[..., self.p:] *= self.tail_inv_diag
        if self.prefix is not None:
            r[..., : self.p] = self.prefix.apply_head(r[..., : self.p], buf)
        if self.inv_perm is not None:
            r = r[..., self.inv_perm]
        return y + r


@dataclasses.dataclass
class CGSolver:
    """cg: AA^T's f64 ELL table, the Jacobi inverse diagonal (f64), the f32
    block-Jacobi inverses (nb, bs, bs) of a prefix of diagonal blocks, and
    FSAI's G and G^T (when present they replace the Jacobi pieces)."""

    inv_diag: torch.Tensor
    bj_inv: Optional[torch.Tensor]
    aat_tbl: EllTable
    fsai_g: Optional[EllTable]
    fsai_gt: Optional[EllTable]
    tol: float
    max_iter: int

    sweeps = False
    eager = "cg: reads the host once per 16 queued CG steps"

    def solve(self, rhs: torch.Tensor, warm: Optional[torch.Tensor]) -> torch.Tensor:
        rhs_hp = rhs.to(torch.float64)
        y = torch.zeros_like(rhs_hp) if warm is None else warm.to(torch.float64)
        y, steps, waits = _pcg(lambda v: _ell_matvec(self.aat_tbl, v), rhs_hp, self._precond(), y,
                               self.tol, self.max_iter)
        trace.add(dict(cg_solves=1, cg_steps=steps, cg_waits=waits))
        return y.to(rhs.dtype)

    def _precond(self) -> Callable:
        """CG's preconditioner z = M^{-1} r (cuadmm_tpu/ops/chol.py:358):
        FSAI's G^T (G r) when built, else the Jacobi diagonal with the dense
        block-Jacobi prefix (in its own f32) over the leading rows."""
        if self.fsai_g is not None:
            g, gt = self.fsai_g, self.fsai_gt
            return lambda r: _ell_matvec(gt, _ell_matvec(g, r))
        inv_diag, bj = self.inv_diag, self.bj_inv

        def apply_m(r: torch.Tensor) -> torch.Tensor:
            z = r * inv_diag
            if bj is not None:
                nd, bs = bj.shape[0], bj.shape[-1]
                head = torch.nn.functional.pad(r, (0, max(0, nd * bs - r.shape[0])))[: nd * bs]
                zh = torch.bmm(bj, head.to(bj.dtype).reshape(nd, bs, 1)).reshape(-1)
                k = min(nd * bs, r.shape[0])
                z[:k] = zh[:k]
            return z

        return apply_m


@dataclasses.dataclass
class HostSolver:
    """host: scipy's LU, rhs (numpy) -> y (numpy), through the host."""

    lu: Callable

    sweeps = False
    eager = "host: the normal solve runs in numpy"

    def solve(self, rhs: torch.Tensor, warm: Optional[torch.Tensor]) -> torch.Tensor:
        y = self.lu(rhs.detach().to("cpu", torch.float64).numpy())
        return torch.as_tensor(y, device=rhs.device).to(rhs.dtype)


@dataclasses.dataclass
class NormalEqSolver:
    """A prepared AA^T solve: the mode, the f64 A of the refinement, the
    mode's factor or factor-free solver, the sweeps a solve and the jitter
    the factor took."""

    mode: str
    sparse_a: SparseA
    factor: "_Factor | CGSolver | HostSolver"
    applies: int = 2
    eps_used: float = 0.0

    @property
    def has_sweeps(self) -> bool:
        """Whether the solve is ``applies`` refinement sweeps of a factor."""
        return self.factor.sweeps

    @property
    def eager_reason(self) -> Optional[str]:
        """Why a CUDA graph cannot hold the solve, or None."""
        return self.factor.eager

    @property
    def inv_l(self) -> Optional[torch.Tensor]:
        """K1's factor (precond's, split's f32 prefix), else None."""
        f = self.factor.prefix if isinstance(self.factor, SplitFactor) else self.factor
        return f.inv_l if isinstance(f, InverseFactor) else None

    @property
    def split_p(self) -> int:
        """split's coupled rows, 0 in every other mode."""
        return self.factor.p if isinstance(self.factor, SplitFactor) else 0

    def solve(self, rhs: torch.Tensor, warm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """y with (AA^T) y ~= rhs, in rhs's dtype, from ``warm`` (or 0).

        ``rhs`` (con_num,) or, for a batch of instances, (B, con_num): the
        sweeps then run on the whole batch; cg and host solve one instance
        at a time. The sweeps' residuals go through the composed A (A^T y),
        whose rounding stays in range(A), which the factor does not amplify."""
        if not self.factor.sweeps:
            return _each(self.factor.solve, rhs, warm)
        rhs_hp = rhs.to(torch.float64)
        y = torch.zeros_like(rhs_hp) if warm is None else warm.to(torch.float64)
        buf = self.factor.buffer(tuple(rhs.shape[:-1]))
        trace.COUNTS["neq_sweeps"] += self.applies
        for _ in range(self.applies):
            y = self.factor.sweep(self.sparse_a, rhs_hp, y, buf)
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


def _jitter_cholesky(aat: torch.Tensor, scale, eps: float, what: str):
    """Cholesky factor of ``aat`` + eps*scale*I, eps x10 until it factors
    and its last diagonal entry is finite: plain Cholesky needs the
    diagonal safely positive on a semidefinite AA^T. Returns (L, eps)."""
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
            raise RuntimeError(f"{what}Cholesky failed even with jitter 1e-1")


def dense_a_fits(con_num: int, vec_len: int, itemsize: int, dense_a_budget: Optional[int]) -> bool:
    """Whether ``_device_factorize`` builds A dense on its device: A beside
    AA^T and its jitter clone fit ``dense_a_budget`` bytes
    (``CardLimits.dense_a_budget``). None (the CPU): always, since the host
    route would hold AA^T densely in the same memory."""
    need = (con_num * vec_len + 2 * con_num * con_num) * itemsize
    return dense_a_budget is None or need <= dense_a_budget


def _device_factorize(
    at_svec_idx,
    at_con_idx,
    vals,
    con_num: int,
    vec_len: int,
    eps: float,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    dense_a_budget: Optional[int] = None,
    timings: Optional[Dict[str, object]] = None,
):
    """Cholesky factor of AA^T + eps*scale*I on ``device`` in ``dtype``.

    Scatters A dense on the device (duplicate COO entries add) and forms
    AA^T with one matmul when ``dense_a_fits``; otherwise the sparse product
    is formed on the host and shipped dense. ``timings``, when given,
    receives ``aat``: where AA^T was formed ("device" or "host"). Returns
    (L, eps), eps as the jitter ladder left it (``_jitter_cholesky``).
    """
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    on_device = dense_a_fits(con_num, vec_len, np.dtype(np_dtype).itemsize, dense_a_budget)
    if timings is not None:
        timings["aat"] = "device" if on_device else "host"
    if on_device:
        rows = torch.as_tensor(np.asarray(at_con_idx, np.int64), device=device)
        cols = torch.as_tensor(np.asarray(at_svec_idx, np.int64), device=device)
        v = torch.as_tensor(np.asarray(vals, np_dtype), device=device)
        a = torch.zeros((con_num, vec_len), dtype=dtype, device=device)
        a.index_put_((rows, cols), v, accumulate=True)
        aat = a @ a.T
        del a
        scale = torch.clamp(torch.trace(aat) / con_num, min=1.0)
    else:
        aat_host = build_aat_host(at_svec_idx, at_con_idx, vals, con_num, vec_len)
        aat = torch.as_tensor(np.asarray(aat_host.todense(), np_dtype), device=device)
        scale = float(max(aat_host.diagonal().sum() / con_num, 1.0))
    return _jitter_cholesky(aat, scale, eps, "AA^T ")


def _jitter_ladder(attempt: Callable, eps: float, what: str):
    """``attempt(eps)`` -> (factor, good) with jitter eps, x10 until good.
    Returns (factor, eps)."""
    cur = float(eps)
    while True:
        factor, good = attempt(cur)
        if good:
            return factor, cur
        del factor
        cur *= 10.0
        if cur > 1e-1:
            raise RuntimeError(f"{what} AA^T Cholesky failed even with jitter 1e-1")


def _tile_factorize(scatter: Callable, factor: Callable, last_tile: int, eps: float, what: str):
    """Scatter and factor tiles with jitter eps, x10 until every diagonal
    tile factored (``factor``'s device status) and the last diagonal entry
    is finite: both read in one device wait. Returns (tiles, eps)."""

    def attempt(cur: float):
        tiles = scatter(cur)
        status = factor(tiles)
        return tiles, bool((status == 0) & torch.isfinite(tiles[last_tile, -1, -1]))

    return _jitter_ladder(attempt, eps, what)


def _tri_inv(l: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a lower-triangular factor.

    Error ~ cond(L) * eps = sqrt(cond(P)) * eps, enough for a refined
    preconditioner. The JAX package blocks this by hand to bound XLA's
    temporaries (cuadmm_tpu/ops/chol.py); here a triangular solve against
    the identity needs two n^2 f32 buffers beside L (and ``pad_factor``'s
    copy one more after the identity is freed: 23.6 GB at n = 44,312), the
    three squares that ``CardLimits.precond_max_n_pad`` bounds. Callers
    pass the result through ``pad_factor``, which keeps only its lower
    triangle.
    """
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def _calibrate_applies(
    neq: NormalEqSolver, con_num: int, device: torch.device, target: Optional[float] = None
) -> NormalEqSolver:
    """Pick the refinement sweep count on the device that will run it.

    Runs the real solve path on a consistent probe rhs = (AA^T) v and takes
    the smallest sweep count whose relative residual beats ``target``
    (None: ``CALIBRATE_TARGET``). Doubles as a factor sanity probe: raises
    if even ``CALIBRATE_MAX_APPLIES`` sweeps cannot reach 1e-2.
    """
    target = CALIBRATE_TARGET if target is None else float(target)
    sa, factor = neq.sparse_a, neq.factor
    buf = factor.buffer()
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(con_num), dtype=torch.float64, device=device)
    rhs = aat_matvec(sa, v)
    y = torch.zeros_like(rhs)
    resids = []
    for _ in range(CALIBRATE_MAX_APPLIES):
        y = factor.sweep(sa, rhs, y, buf)
        resids.append(torch.linalg.norm(rhs - aat_matvec(sa, y)))
    curve = (torch.stack(resids) / torch.linalg.norm(rhs)).cpu().numpy()
    ok = np.isfinite(curve) & (curve < target)
    if ok.any():
        return dataclasses.replace(neq, applies=int(np.argmax(ok)) + 1)
    best = int(np.nanargmin(curve)) if np.isfinite(curve).any() else CALIBRATE_MAX_APPLIES - 1
    if not np.isfinite(curve[best]) or curve[best] > 1e-2:
        raise RuntimeError(
            f"normal-equation factor failed the on-device probe: relative "
            f"residual curve {curve} (eps_used={neq.eps_used:g}). The "
            "factorization is unusable; try normal_solver='cg' or a larger precond_eps."
        )
    return dataclasses.replace(neq, applies=best + 1)


def _block_jacobi_inv(aat: sp.csr_matrix, con_num: int, block: int, eps: float, dtype, device):
    """Inverses of the dense diagonal blocks of AA^T (host, f64), stacked
    (nd, block, block) in ``dtype`` on ``device``; None when no block has
    off-diagonal entries. Copy of cuadmm_tpu/ops/chol.py::_block_jacobi_inv:
    only the prefix of blocks up to the last one with off-diagonal
    structure is kept (the Jacobi diagonal is exact past it), with the
    identity on the last block's padding."""
    nb = (con_num + block - 1) // block
    aat_csc = aat.tocsc()
    nd = 0
    subs = []
    for i in range(nb):
        s, e = i * block, min((i + 1) * block, con_num)
        sub = aat_csc[s:e, s:e]
        subs.append(sub)
        # Structural test: nnz against the nonzero diagonal, not the row
        # count (all-zero rows would offset off-diagonal entries).
        if sub.nnz > np.count_nonzero(sub.diagonal()):
            nd = i + 1
    if nd == 0:
        return None
    out = np.zeros((nd, block, block), dtype=np.float64)
    for i in range(nd):
        s, e = i * block, min((i + 1) * block, con_num)
        d = np.asarray(subs[i].todense())
        scale = max(np.trace(d) / max(e - s, 1), 1.0)
        d[np.diag_indices(e - s)] += eps * scale
        try:
            inv = np.linalg.inv(np.linalg.cholesky(d) @ np.linalg.cholesky(d).T)
        except np.linalg.LinAlgError:
            d[np.diag_indices(e - s)] += 1e-6 * scale
            inv = np.linalg.inv(d)
        out[i, : e - s, : e - s] = inv
        for j in range(e - s, block):
            out[i, j, j] = 1.0
    return torch.as_tensor(out, device=device).to(dtype)


def _resolve_auto(at_svec_idx, at_con_idx, vals, con_num, vec_len, dtype, on_accel, dense_chol_max,
                  n_devices: int = 1, limits: Optional[CardLimits] = None):
    """``auto`` as the JAX package resolves it (cuadmm_tpu/ops/chol.py:
    781-847), ``n_devices`` the mesh's size, past dense_chol_max on an
    accelerator with ``limits``' numbers (``past_ceiling_mode``). Returns
    (mode, AA^T on the host or None, RCM probe or None); the last two are
    only computed past dense_chol_max on an accelerator."""
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
        mode = past_ceiling_mode(con_num, band_probe[0] if band_probe else None, on_accel, n_devices, limits)
    if not on_accel:  # the JAX package's CPU factor-size guards
        if mode == "dense" and con_num * con_num * 8 > cpu_max_factor_bytes:
            mode = "precond"
        if mode == "precond" and con_num * con_num * 4 > cpu_max_factor_bytes:
            mode = "cg"
    return mode, aat, band_probe


def _check_precond_fits(n: int, limits: Optional[CardLimits], mode: str) -> None:
    """Raise, before anything is allocated, when an inverse factor of ``n``
    rows (precond's, or split's prefix) passes ``limits.precond_max_n_pad``:
    its build holds three f32 squares of n_pad. No limits (the CPU): no
    check."""
    n_pad = -(-n // LANE) * LANE
    if limits is not None and n_pad > limits.precond_max_n_pad:
        square = 4.0 * n_pad * n_pad
        raise ValueError(
            f"normal_solver={mode!r}: the inverse factor's build holds three f32 squares of n_pad "
            f"{n_pad} ({3 * square / 1e9:.2f} GB), past the n_pad {limits.precond_max_n_pad} that "
            f"its device's {limits.total_bytes / 1e9:.2f} GB allow; lower dense_chol_max or use "
            "normal_solver='banded', 'packed' or 'cg'"
        )


def _precond_factor(a: tuple, precond_eps, device, limits, timings, stages):
    """precond: AA^T's f32 factor with the jitter ladder from
    max(precond_eps, 1e-5), inverted for K1 (only the inverse is kept:
    ``del l`` frees n^2 of device memory)."""
    l, eps_used = _device_factorize(*a, max(precond_eps, 1e-5), device, torch.float32,
                                    None if limits is None else limits.dense_a_budget, timings)
    stages.begin("tri_inv")
    inv_l = pad_factor(_tri_inv(l))
    del l
    stages.begin("calibrate")
    return InverseFactor(inv_l), eps_used


def _dense_factor(a: tuple, eps, device, limits, timings, stages):
    """dense: AA^T's f64 factor with the jitter ladder from max(eps, 1e-14)."""
    l, eps_used = _device_factorize(*a, max(eps, 1e-14), device, torch.float64,
                                    None if limits is None else limits.dense_a_budget, timings)
    stages.begin("calibrate")
    return CholFactor(l), eps_used


def _split_factor(a: tuple, dense_chol_max, precond_eps, device, limits, stages):
    """split (cuadmm_tpu/ops/chol.py:922-1031): the coupled set S from the
    shared-column probe, the p x p prefix A_S A_S^T formed on the host and
    factored in f32 with the jitter ladder from max(precond_eps, 1e-5)
    (relative to the mean diagonal of AA^T), inverted for K1; the other rows'
    diagonal inverse in f64 with the JAX package's floor. p = 0 (a diagonal
    AA^T) builds no factor."""
    at_svec_idx, at_con_idx, vals, con_num, vec_len = a
    col_mult = np.bincount(at_svec_idx, minlength=vec_len)
    S = np.unique(at_con_idx[col_mult[at_svec_idx] >= 2])
    p = len(S)
    if p > dense_chol_max:
        raise ValueError(
            f"normal_solver='split': coupled set is {p} rows, past dense_chol_max={dense_chol_max}"
        )
    _check_precond_fits(p, limits, "split")
    diag = np.bincount(at_con_idx, weights=np.asarray(vals) ** 2, minlength=con_num)
    scale = max(float(diag.mean()), 1e-30)
    perm = np.concatenate([S, np.setdiff1d(np.arange(con_num), S)])
    identity = bool(np.array_equal(perm, np.arange(con_num)))
    eps_used = max(precond_eps, 1e-5)
    prefix = None
    if p:
        a_s = sp.csr_matrix((vals, (at_con_idx, at_svec_idx)), shape=(con_num, vec_len))[S]
        sub = torch.as_tensor((a_s @ a_s.T).toarray(), dtype=torch.float32, device=device)
        l, eps_used = _jitter_cholesky(sub, scale, eps_used, "split-prefix ")
        del sub
        prefix = InverseFactor(pad_factor(_tri_inv(l)))
    td = diag[perm[p:]]
    td = np.where(td > 1e-12 * scale, td, scale)
    as_idx = lambda v: None if identity else torch.as_tensor(v, dtype=torch.int64, device=device)
    factor = SplitFactor(prefix, p, torch.as_tensor(1.0 / td, dtype=torch.float64, device=device),
                         as_idx(perm), as_idx(np.argsort(perm)))
    stages.begin("calibrate")
    return factor, eps_used


def _packed_factor(aat, con_num, precond_eps, device, stages):
    """packed: AA^T's lower triangle in B x B tiles (B 1024 past 2,048
    rows, else 256), factored in f32 with the jitter ladder from
    max(precond_eps, 1e-5)."""
    coo = aat.tocoo()
    diag_mean = float(aat.diagonal().mean())
    lay = tri_stream.make_layout(con_num, 1024 if con_num > 2048 else 256)
    rows, cols = coo.row.astype(np.int64), coo.col.astype(np.int64)
    tiles, eps_used = _tile_factorize(
        lambda e: tri_stream.scatter_packed_aat(rows, cols, coo.data, lay, e, diag_mean, torch.float32, device),
        lambda tl: tri_stream.packed_cholesky(tl, lay),
        tri_stream.tid(lay.nb - 1, lay.nb - 1),
        max(precond_eps, 1e-5),
        "packed",
    )
    stages.begin("calibrate")
    return PackedFactor(tiles, lay), eps_used


def _band_factor(aat, con_num, band_probe, precond_eps, device, limits, timings, stages):
    """banded: AA^T's band under its RCM permutation (``band_probe``,
    computed here when ``auto`` did not), its block picked by ``limits``'
    band model. Where the band falls apart into independent segments and
    K3's segments form beats the tile forms' model of it
    (``limits.segment_form``), each segment is factored on its own
    (``SegmentFactor``); else the block band is factored in f32 and K3
    takes its tile form for the card (``BandFactor``)."""
    coo = aat.tocoo()
    diag_mean = float(aat.diagonal().mean())
    bw, perm = band_probe if band_probe is not None else _rcm_bandwidth(aat)
    pinv = np.empty_like(perm)
    pinv[perm] = np.arange(con_num)
    model = lim.BAND_MODEL if limits is None else limits.bound_band_model()
    lay = tri_stream.make_band_layout(con_num, bw, model=model)
    rows, cols = pinv[coo.row].astype(np.int64), pinv[coo.col].astype(np.int64)
    bounds = tri_stream.segment_bounds(np.minimum(rows, cols), np.maximum(rows, cols), con_num)
    max_seg = int(np.diff(bounds).max())
    seg_model = lim.SEGMENT_MODEL if limits is None else limits.segment_model
    # The jitter ladder starts at 1e-5 rather than precond_eps: a
    # band factors fine there, and the looser 1e-4 costs a sweep.
    eps = max(min(precond_eps, 1e-5), 1e-7)
    if lim.segment_form(seg_model, con_num, bw, max_seg, model(lay.T, lay.block, lay.nb)):
        # Each segment factored in f64 on the host.
        seg, eps_used = _jitter_ladder(
            lambda e: tri_stream.segment_band(rows, cols, coo.data, bounds, bw, perm, e, diag_mean, device), eps,
            "band")
        factor = SegmentFactor(seg)
        stages.begin("calibrate")
        held = f"form=segments segments={seg.n_segments} max={seg.max_seg} bytes={seg.band.numel() * 4}"
    else:
        tiles, eps_used = _tile_factorize(
            lambda e: tri_stream.scatter_band_aat(rows, cols, coo.data, lay, e, diag_mean, torch.float32, device),
            lambda tl: tri_stream.band_cholesky(tl, lay),
            tri_stream.tid_band(lay.nb - 1, lay.nb - 1, lay),
            eps,
            "band",
        )
        stages.begin("calibrate")
        form, chain = chain_tiles(tiles, lay, None if limits is None else limits.band_max_bytes)
        held = (f"nb={lay.nb} nbw={lay.nbw} B={lay.block} bytes={tri_stream.band_bytes(lay, form)} "
                f"form={'one-hop' if form == 'chain' else 'two-hop'}")
        identity = bool(np.array_equal(perm, np.arange(con_num)))
        as_idx = lambda p: None if identity else torch.as_tensor(np.asarray(p, np.int64), device=device)
        factor = BandFactor(tiles, lay, form, chain, as_idx(perm), as_idx(pinv))
    if timings is not None:
        timings["band_bw"] = int(bw)
        timings["band_layout"] = held
        timings["band_segments"] = len(bounds) - 1
        timings["band_max_segment"] = max_seg
    return factor, eps_used


def _cg_solver(aat, con_num, eps, cg_tol, cg_max_iter, cg_block_jacobi, cg_precond,
               fsai_cap, fsai_pattern_power, device, stages, timings):
    """cg (cuadmm_tpu/ops/chol.py:1260-1356), f64 throughout but for the
    f32 block-Jacobi inverses. ``cg_precond`` "auto" builds FSAI and drops
    to block-Jacobi if the build fails; "fsai" raises then; "block_jacobi"
    takes the prefix of dense diagonal blocks (when con_num >
    cg_block_jacobi > 0); "jacobi" only the diagonal."""
    f64 = torch.float64
    fsai_g = fsai_gt = bj = None
    if cg_precond in ("auto", "fsai"):
        try:
            G = build_fsai(aat, eps_rel=max(eps, 1e-10), pattern_power=fsai_pattern_power, cap=fsai_cap)
            stages.begin(None)
            if timings is not None:
                timings["fsai_nnz"] = int(G.nnz)
            fsai_g, fsai_gt = fsai_tables(G, f64, device)
        except (np.linalg.LinAlgError, ValueError, MemoryError, torch.OutOfMemoryError):
            if cg_precond == "fsai":
                raise
    if fsai_g is None and cg_precond != "jacobi" and cg_block_jacobi and con_num > cg_block_jacobi:
        bj = _block_jacobi_inv(aat, con_num, cg_block_jacobi, max(eps, 1e-10), torch.float32, device)
    # The Jacobi diagonal serves every row past the block-Jacobi prefix; an
    # all-zero AA^T row gets the mean diagonal, not a 1e30 spike.
    diag = aat.diagonal()
    scale = max(float(diag.mean()), 1e-30)
    d = np.where(diag > 1e-12 * scale, diag, scale)
    coo = aat.tocoo()
    tbl = _build_ell(coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data, con_num, con_num, f64, device)
    return CGSolver(torch.as_tensor(1.0 / d, dtype=f64, device=device), bj, tbl, fsai_g, fsai_gt,
                    cg_tol, cg_max_iter), 0.0


def _host_solver(aat, con_num, eps, on_accel):
    """host: scipy's sparse LU of AA^T + max(eps, 1e-14) I."""
    if on_accel:
        warnings.warn("normal_solver='host' factorizes on the host: every solve copies rhs to the host and the "
                      "answer back; prefer 'auto' on CUDA.")
    return HostSolver(spla.factorized((aat + max(eps, 1e-14) * sp.eye(con_num, format="csr")).tocsc())), 0.0


def _sharded_factor(aat, con_num, mesh: Mesh, precond_eps, device, timings, stages):
    """sharded (cuadmm_tpu/ops/chol.py:1188-1256), with the JAX package's
    block size (1024 from 64k rows, else a power of two near con_num / 4
    ranks, at least 64), nb a multiple of the mesh size, the f32 factor's jitter
    ladder from max(precond_eps, 1e-5) with the probe of the last diagonal
    entry. Raises, before allocating, when a rank's slab does not fit its
    device's memory (the JAX package picks the mode without a look,
    chol.py:834-838)."""
    D = mesh.size
    blk = 1024 if con_num >= 64 * 1024 else max(64, 1 << max(0, (con_num // (4 * D)).bit_length() - 1))
    blk = min(blk, 1024)
    nb, _ = tri_shard.make_grid_layout(con_num, D, blk)
    slab_bytes = nb * (nb // D) * blk * blk * 4
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        if slab_bytes > total:
            raise ValueError(
                f"normal_solver='sharded': a rank's factor slab is {slab_bytes / 1e9:.2f} GB "
                f"(nb {nb} x {nb // D} columns x {blk}^2 x 4 bytes over {D} ranks), past its "
                f"device's {total / 1e9:.2f} GB; use more ranks"
            )
    diag_mean = float(aat.diagonal().mean())
    cur = max(precond_eps, 1e-5)
    while True:
        slab = tri_shard.sharded_scatter_aat(aat, con_num, nb, blk, mesh, eps=cur, diag_mean=diag_mean)
        slab = tri_shard.sharded_cholesky(slab, mesh)
        if tri_shard.last_diag_finite(slab, mesh):
            break
        del slab
        cur *= 10.0
        if cur > 1e-1:
            raise RuntimeError("sharded AA^T Cholesky failed even with jitter 1e-1")
    if timings is not None:
        timings["sharded_layout"] = f"nb={nb} B={blk} ranks={D} bytes_per_rank={slab_bytes}"
    stages.begin("calibrate")
    return ShardedFactor(slab, mesh), cur


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
    eps: float = 1e-15,
    cg_tol: float = 0.0,
    cg_max_iter: int = 400,
    cg_block_jacobi: int = 2048,
    cg_precond: str = "auto",
    fsai_cap: int = 64,
    fsai_pattern_power: int = 2,
    calibrate_target: Optional[float] = None,
    mesh: Optional[Mesh] = None,
    limits: Optional[CardLimits] = None,
) -> NormalEqSolver:
    """Prepare the solve once at init and return a device-resident solver.

    ``mode="auto"`` resolves as the JAX package does on the device's kind
    (``_resolve_auto``, with the size of ``mesh``); ``sharded`` needs the
    ``mesh``, and every rank of it builds its share of the factor.
    ``sparse_a`` is the f64 A of the refinement. ``eps`` (SolverConfig's
    aat_eps) regularizes the f64 factors, FSAI, block-Jacobi and host's LU;
    ``cg_tol`` <= 0 takes the default of the state dtype ``dtype`` (2e-7 in
    f32, 64 eps in f64); CG's rhs and iterate are f64 either way.
    ``calibrate_target`` is the relative residual the calibrated sweep
    count must reach in every mode with sweeps (None: ``CALIBRATE_TARGET``,
    the f64 state's).
    ``timings``, when given, receives the wall seconds of each stage (and
    the band's bandwidth and layout, FSAI's nonzeros, where AA^T was formed).
    ``limits`` are the device's (None: ``card_limits(device)`` on CUDA,
    none on the CPU): ``auto``'s numbers past dense_chol_max, the dense-A
    budget, and the inverse factor's largest n_pad, past which precond and
    split raise before they allocate.
    """
    on_accel = device.type == "cuda"
    if limits is None and on_accel and mode not in ("cg", "host"):
        limits = card_limits(device)
    if mode == "inv":  # legacy alias
        mode = "precond"
    aat = band_probe = None
    if mode == "auto":
        mode, aat, band_probe = _resolve_auto(
            at_svec_idx, at_con_idx, vals, con_num, vec_len, dtype, on_accel, dense_chol_max,
            1 if mesh is None else mesh.size, limits,
        )
    if mode not in ("precond", "dense", "split", "packed", "banded", "sharded", "cg", "host"):
        raise ValueError(f"unknown normal_solver {mode!r}")
    if mode == "precond" and con_num > dense_chol_max:
        raise ValueError(
            f"normal_solver='precond' needs con_num <= dense_chol_max={dense_chol_max}, "
            f"got {con_num}"
        )
    if mode == "precond":
        _check_precond_fits(con_num, limits, mode)
    if mode == "sharded" and mesh is None:
        raise ValueError("normal_solver='sharded' requires a device mesh (SDPSolver(mesh=...))")
    if cg_tol is None or cg_tol <= 0.0:
        cg_tol = 2e-7 if dtype == torch.float32 else 64.0 * torch.finfo(torch.float64).eps

    # Each stage a span ``neq.<stage>`` and its seconds in ``timings``; a
    # kernel build inside one is left out of it and counted as ``build``.
    first = dict(precond="factorize", dense="factorize", split="split_factorize", sharded="sharded_factorize",
                 packed="packed_factorize", banded="band_factorize",
                 cg="fsai_build" if cg_precond in ("auto", "fsai") else None).get(mode)
    a = (at_svec_idx, at_con_idx, vals, con_num, vec_len)
    host_aat = lambda: build_aat_host(*a) if aat is None else aat
    with trace.Stages("neq", timings, device, builds=True) as stages:
        stages.begin(first)
        factor, eps_used = dict(
            precond=lambda: _precond_factor(a, precond_eps, device, limits, timings, stages),
            dense=lambda: _dense_factor(a, eps, device, limits, timings, stages),
            split=lambda: _split_factor(a, dense_chol_max, precond_eps, device, limits, stages),
            packed=lambda: _packed_factor(host_aat(), con_num, precond_eps, device, stages),
            banded=lambda: _band_factor(host_aat(), con_num, band_probe, precond_eps, device, limits, timings,
                                        stages),
            sharded=lambda: _sharded_factor(host_aat(), con_num, mesh, precond_eps, device, timings, stages),
            cg=lambda: _cg_solver(host_aat(), con_num, eps, cg_tol, cg_max_iter, cg_block_jacobi, cg_precond,
                                  fsai_cap, fsai_pattern_power, device, stages, timings),
            host=lambda: _host_solver(host_aat(), con_num, eps, on_accel),
        )[mode]()
        if not factor.sweeps:
            return NormalEqSolver(mode, sparse_a, factor)
        neq = NormalEqSolver(mode, sparse_a, factor, max(applies, 1), eps_used)
        return neq if applies > 0 else _calibrate_applies(neq, con_num, device, calibrate_target)
