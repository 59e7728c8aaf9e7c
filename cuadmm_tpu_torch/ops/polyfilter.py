"""Factorization-free PSD projection via composite polynomial filtering.

Port of cuadmm_tpu/ops/polyfilter.py. Pi(X) = (X + sign(X) X) / 2, with
sign(X) approximated by a fixed composition of odd degree-5 polynomials
evaluated as batched matmuls: no eigendecomposition and no host wait.
The schedules are the JAX package's, digit for digit (see there for how
they were computed and their accuracy: sign error < 3e-15 for eigenvalues
of magnitude >= 1e-6 of the scale in f64). The JAX package computes these
outside any Pallas kernel, so they are ``torch.matmul`` here; TF32 is off
on CUDA (``device.resolve_device``), the counterpart of
``Precision.HIGHEST``.

Over a rank mesh (``mesh=``) each product is split by rows, as XLA
partitions the JAX filter's GEMMs when parallel/mesh.py shards a block's
row axis: a rank computes its rows of X @ Y and one masked all_reduce
rebuilds X @ Y on every rank for the next product. A step's three products
take three all_reduces (two where c = 0), and the final product one more:
40 a projection with the f64 schedule, 28 with the f32 one.

One triangle. Every product of the filter is a product of two commuting
symmetric matrices (Y Y, A A, Y p(A), and the final Z Y0), so it is
symmetric, and half of a full GEMM's flops compute the triangle that the
symmetrization averages away. For one large matrix (``one_triangle``: a
batch of one, n >= TRI_MIN_N of its dtype, no row mesh) the filter
computes only the upper triangle of each product, by cuBLAS's syrk (Y Y,
c A A) and syrkx (Y P, Z Y0), and restores the full matrix with one
mirror pass that also folds in the polynomial (ops/sym_products.py,
csrc/sym_mirror.cu): P = c A^2 + b A + a I in the pass after c A^2, and
0.5 s (Z Y0 + Y0) in the last. A step makes three triangle products (two
where c = 0), and the last product one more: 40 with the f64 schedule,
28 with the f32 one (``trace.COUNTS["poly_tri_products"]``), in three
work matrices written in place. It is the same polynomial in the same
precision, without the redundant half. The products are bound by the
card's f64 tensor-core rate (67 TFLOP/s on the H100; syrk and syrkx
reach about 50 useful TFLOP/s at n = 2004, the full GEMM 55); the mirror
passes by bytes. Below TRI_MIN_N, where cuBLAS's syrk loses to its GEMM
(poly_ab.py, PERF.md), and for batched buckets (cuBLAS has no batched
syrk), a row mesh and stacked instances, the full GEMMs stay: one batched
GEMM a product over the whole bucket, 40 a projection with the f64
schedule and 28 with the f32 one (``trace.COUNTS["poly_gemm_products"]``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.ops import sym_products
from cuadmm_tpu_torch.parallel.mesh import Mesh, shard_bounds

# Schedules: tuples of (a, b, c) with p(y) = a y + b y^3 + c y^5.
# Spectrum is assumed scaled into [-1, 1] (see psd_project_poly).

# l0 = 1e-4, 9 steps; f32-safe (sign err 1.2e-7 in f32 arithmetic).
SIGN_SCHEDULE_F32: Tuple[Tuple[float, float, float], ...] = (
    (5.06047547263284869, -14.99362338586087162, 11.10746479402847875),
    (4.25120419845484410, -8.88976190955811951, 4.64979926111216368),
    (4.24571098539345027, -8.85721646226934034, 4.62959100189469730),
    (4.22236221862099459, -8.71977786520939802, 4.54432714133642790),
    (4.12275283299936568, -8.14952734821208402, 4.19191420784630875),
    (3.72058281932766732, -6.10090498086843347, 2.94788819441030192),
    (2.30294699725781049, -2.07561612521402372, 0.74862622025722247),
    (1.87590301995105002, -1.25100299068303422, 0.37510031404681154),
    (0.00000000000000000, 2.49999430934171984, -1.49999430768382047),
)

# l0 = 1e-6, 13 steps; final sign error 2.2e-16 in f64.
SIGN_SCHEDULE_F64: Tuple[Tuple[float, float, float], ...] = (
    (5.06094475801049359, -14.99756667466204796, 11.11093279514654597),
    (4.25288216574223910, -8.89971842980909145, 4.65598243456068328),
    (4.25282998115375843, -8.89940878282711090, 4.65579013835168354),
    (4.25260782639308221, -8.89809058639797001, 4.65497151521643282),
    (4.25166151183467633, -8.89247545825870844, 4.65148442209067348),
    (4.24763473434524208, -8.86860530927969215, 4.63666207529563934),
    (4.23052068487935529, -8.76763876835256006, 4.57400543139323368),
    (4.15780256493974854, -8.34723344775049902, 4.31384066587466553),
    (3.85649202718224737, -6.74910730373869772, 3.33720851459665591),
    (2.92318240820907116, -3.11041421885981695, 1.23637796668017064),
    (1.68172025850201989, -0.89906693481348410, 0.21538884141076403),
    (1.88332354894469689, -1.26664670669541635, 0.38332315678453022),
    (1.87500000000000000, -1.25000000000000000, 0.37500000000000000),
)


def default_schedule(dtype: torch.dtype) -> Tuple[Tuple[float, float, float], ...]:
    return SIGN_SCHEDULE_F64 if dtype == torch.float64 else SIGN_SCHEDULE_F32


# The smallest n at which one matrix takes the one-triangle route, by dtype:
# where it beat the GEMMs at every n measured from there up to 2048 on the
# H100 (f64 from 504, 3.6x slower at 496, where cuBLAS's syrk takes another
# kernel; f32 from 1500, about even at 1100-1400; poly_ab.py, PERF.md).
TRI_MIN_N: Dict[torch.dtype, int] = {torch.float64: 504, torch.float32: 1500}


def one_triangle(mats: torch.Tensor, mesh: Optional[Mesh] = None) -> bool:
    """Whether the filter of ``mats`` takes the one-triangle route: one
    f64 or f32 matrix of n >= TRI_MIN_N[dtype], not split over a mesh."""
    n = mats.shape[-1]
    return (mats.dtype in TRI_MIN_N and n >= TRI_MIN_N[mats.dtype] and mats.numel() == n * n
            and (mesh is None or mesh.size <= 1))


def _tri(out: torch.Tensor) -> torch.Tensor:
    """One triangle product of the route, counted (on any device)."""
    trace.COUNTS["poly_tri_products"] += 1
    return out


def _sign_tri(y0: torch.Tensor, schedule) -> Tuple[torch.Tensor, list]:
    """sign(y0) of one (n, n) matrix on one triangle: a step's products
    Y^2, c A^2 and Y p(A) by syrk, syrk and syrkx, each restored by one
    mirror pass, which also folds in the polynomial (P = c A^2 + b A + a I
    in the pass after c A^2). Three work matrices, written in place; returns
    sign(y0) and the work matrices left free."""
    free = [torch.empty_like(y0) for _ in range(3)]
    y = y0
    for a, b, c in schedule:
        sq = _tri(sym_products.syrk(y, free.pop()))
        if c == 0.0:  # P = a I + b A, in A's own mirror pass
            poly = sym_products.mirror(sq, alpha=b, shift=a)
        else:
            sym_products.mirror(sq)
            poly = _tri(sym_products.syrk(sq, free.pop(), alpha=c))
            sym_products.mirror(poly, add=sq, add_coef=b, shift=a)
            free.append(sq)
        nxt = sym_products.mirror(_tri(sym_products.syrkx(y, poly, free.pop())))
        free.append(poly)
        if y is not y0:
            free.append(y)
        y = nxt
    return y, free


def _sym(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * (y + y.transpose(-1, -2))


def _product(x: torch.Tensor, y: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """x @ y, one batched GEMM of the full-GEMM route, counted (on any
    device); over a mesh, this rank's rows of it and one masked all_reduce."""
    trace.COUNTS["poly_gemm_products"] += 1
    if mesh is None or mesh.size <= 1:
        return x @ y
    lo, hi = shard_bounds(x.shape[-2], mesh)
    out = x.new_zeros(x.shape[:-1] + y.shape[-1:])
    out[..., lo:hi, :] = x[..., lo:hi, :] @ y
    return mesh.all_reduce(out)


def matrix_sign(
    mats: torch.Tensor,
    schedule: Optional[Sequence[Tuple[float, float, float]]] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Approximate sign(X) for symmetric X with spectrum in [-1, 1].

    Each step evaluates p(Y) = Y (a I + b A + c A^2), A = Y^2: three batched
    matmuls, split by rows over ``mesh``. Symmetry is restored after every
    step.
    """
    if schedule is None:
        schedule = default_schedule(mats.dtype)
    if one_triangle(mats, mesh):
        return _sign_tri(mats.reshape(mats.shape[-2:]).contiguous(), schedule)[0].reshape(mats.shape)
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
    y = mats
    for a, b, c in schedule:
        a2 = _product(y, y, mesh)
        if c == 0.0:
            poly = a * eye + b * a2
        else:
            poly = a * eye + b * a2 + c * _product(a2, a2, mesh)
        y = _sym(_product(y, poly, mesh))
    return y


def spectral_scale(mats: torch.Tensor) -> torch.Tensor:
    """Per-matrix upper bound on the spectral norm: the smaller of the
    Frobenius norm and the largest absolute row sum."""
    fro = torch.sqrt(torch.sum(mats * mats, dim=(-1, -2)))
    inf = torch.amax(torch.sum(torch.abs(mats), dim=-1), dim=-1)
    s = torch.minimum(fro, inf)
    return torch.clamp(s, min=torch.finfo(mats.dtype).tiny * 16)


def psd_project_poly(
    mats: torch.Tensor,
    schedule: Optional[Sequence[Tuple[float, float, float]]] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Project a batch of symmetric matrices onto the PSD cone, matmul-only.

    Exact blockwise for block-diagonal inputs, so it composes with packed
    super-matrices; zero padding stays zero (every filter polynomial is
    odd). A non-finite matrix comes out non-finite. With ``mesh`` every rank
    passes the whole batch and gets the whole projection; the products are
    split by rows over the ranks.
    """
    s = spectral_scale(mats)[..., None, None]
    y0 = mats / s
    if one_triangle(mats, mesh):
        y0 = y0.reshape(mats.shape[-2:])
        z, free = _sign_tri(y0, default_schedule(mats.dtype) if schedule is None else schedule)
        out = _tri(sym_products.syrkx(z, y0, free.pop()))
        return sym_products.mirror(out, add=y0, scale=s, alpha=0.5).reshape(mats.shape)
    z = matrix_sign(y0, schedule, mesh)
    return 0.5 * s * _sym(y0 + _product(z, y0, mesh))
