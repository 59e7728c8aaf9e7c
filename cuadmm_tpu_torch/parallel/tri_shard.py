"""The ``sharded`` normal solver's factor: a distributed blocked Cholesky of
AA^T and its triangular solves, over a rank mesh.

Port of cuadmm_tpu/parallel/tri_shard.py. The factor is an (nb, nb) grid
of B x B tiles whose block columns are split over the ranks: rank r holds
the contiguous slab of columns [r ncl, (r+1) ncl), ncl = nb / size, as an
(nb, ncl, B, B) tensor on its device, zero above the diagonal, the
diagonal tiles inverted. Each function is the JAX one's counterpart, run by
every rank of the mesh in lockstep (SPMD), with the JAX package's psums as
masked all_reduces (parallel/mesh.py). The collectives run at every mesh
size, one rank included, as shard_map's do.

Two departures from the JAX code, both defects of the reference:

- No dense host slab. tri_shard.py:187 densifies an n_pad x w host slab
  per device (9.7 GB of f32 per rank at the 20x120 grid over 2 ranks,
  twice that through ``todense``'s f64). ``sharded_scatter_aat`` scatters
  the rank's share of AA^T's lower triangle straight into its device slab:
  the host holds only that share's nonzeros.
- No full masked trailing update. The JAX Cholesky forms the whole masked
  (nb, ncl, B, B) update every step (tri_shard.py:253-258): every tile's
  product, live or not, and a second slab of memory. ``sharded_cholesky``
  updates only the live tiles (rows i >= j > k of its columns j), in place;
  each is the same product.

The backward sweep takes one all_reduce a step where the JAX code takes
two: the deltas of step j fall on t's entries of the rank's own columns,
which only that rank reads, so only y_j crosses ranks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch.ops.tri_stream import tid
from cuadmm_tpu_torch.parallel.mesh import Mesh


def square_tiles_from_packed(tiles, lay) -> np.ndarray:
    """(nb, nb, B, B) tile grid (host) from packed tiles (ops/tri_stream.py):
    zeros above the diagonal; the diagonal tiles stay inverted."""
    tiles = np.asarray(tiles)
    nb, B = lay.nb, lay.block
    out = np.zeros((nb, nb, B, B), tiles.dtype)
    for i in range(nb):
        for j in range(i + 1):
            out[i, j] = tiles[tid(i, j)]
    return out


def _columns(nb: int, mesh: Mesh) -> Tuple[int, int]:
    """(first global block column of this rank, columns per rank)."""
    if nb % mesh.size:
        raise ValueError(f"{nb} block columns do not split over {mesh.size} ranks (make_grid_layout)")
    ncl = nb // mesh.size
    return mesh.rank * ncl, ncl


def shard_factor(square_tiles, mesh: Mesh) -> torch.Tensor:
    """This rank's column slab (nb, ncl, B, B), on its device, of a host
    (nb, nb, B, B) grid."""
    grid = np.asarray(square_tiles)
    c0, ncl = _columns(grid.shape[0], mesh)
    return torch.as_tensor(np.ascontiguousarray(grid[:, c0:c0 + ncl]), device=mesh.device)


def make_grid_layout(n: int, n_dev: int, block: int = 1024) -> Tuple[int, int]:
    """(nb, n_pad) with nb a multiple of the mesh size."""
    nb = -(-n // block)
    nb = -(-nb // n_dev) * n_dev
    return nb, nb * block


def sharded_scatter_aat(
    aat, n: int, nb: int, block: int, mesh: Mesh, eps: float = 1e-5, diag_mean: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """This rank's column slab (nb, ncl, B, B) of the lower triangle of
    AA^T + eps max(diag_mean, 1) I, with a unit diagonal on the padding
    rows, in ``dtype`` on the mesh's device. ``aat`` is the host scipy
    matrix; its values round to ``dtype`` once, before the regularization
    is added, as the JAX package builds them."""
    B = block
    c0, ncl = _columns(nb, mesh)
    lo, hi = c0 * B, (c0 + ncl) * B
    cols = sp.csc_matrix(aat)[:, lo:min(hi, n)].tocoo()
    keep = cols.row >= cols.col + lo  # the lower triangle
    row, col = cols.row[keep].astype(np.int64), cols.col[keep].astype(np.int64)
    slab = torch.zeros((nb, ncl, B, B), dtype=dtype, device=mesh.device)
    flat = slab.view(-1)
    idx = ((row // B) * ncl + col // B) * (B * B) + (row % B) * B + col % B
    flat.index_put_(
        (torch.as_tensor(idx, device=mesh.device),),
        torch.as_tensor(cols.data[keep], device=mesh.device).to(dtype),
        accumulate=True,
    )
    c = np.arange(lo, hi)  # the slab's own columns: diagonal entries
    didx = torch.as_tensor(((c // B) * ncl + (c - lo) // B) * (B * B) + (c % B) * (B + 1), device=mesh.device)
    real = torch.as_tensor(c < n, device=mesh.device)
    scale = eps * max(float(diag_mean), 1.0)
    flat[didx] = torch.where(real, flat[didx] + scale, torch.ones((), dtype=dtype, device=mesh.device))
    return slab


def sharded_cholesky(slab: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Distributed right-looking blocked Cholesky of the column slabs, in
    place; the diagonal tiles come out inverted (what ``sharded_tri_solve``
    reads). Returns ``slab``.

    Step k: the owner of column k broadcasts its live part (rows >= k);
    every rank factors the diagonal tile (its symmetrized lower triangle),
    inverts the factor and scales the panel L[i,k] = A[i,k] inv(L_kk)^T;
    the owner stores them; each rank subtracts L[i,k] L[j,k]^T from its
    own live tiles (i >= j > k). A diagonal tile that does not factor
    becomes NaN, which reaches the last diagonal entry (``last_diag_finite``).
    """
    nb, ncl, B, _ = slab.shape
    c0 = mesh.rank * ncl
    col = torch.empty((nb, B, B), dtype=slab.dtype, device=slab.device)
    eye = torch.eye(B, dtype=slab.dtype, device=slab.device)
    for k in range(nb):
        owner = k // ncl
        if owner == mesh.rank:
            col[k:] = slab[k:, k - c0]
        mesh.broadcast(col[k:], owner)
        dkk = torch.tril(col[k]) + torch.tril(col[k], -1).T
        lkk, info = torch.linalg.cholesky_ex(dkk)
        lkk = torch.where(info == 0, lkk, torch.nan)
        ikk = torch.linalg.solve_triangular(lkk, eye, upper=False)
        panel = col[k + 1:] @ ikk.T  # (nb - k - 1, B, B): L[i, k] for i > k
        if owner == mesh.rank:
            slab[k, k - c0] = ikk
            slab[k + 1:, k - c0] = panel
        for jl in range(max(k + 1 - c0, 0), ncl):
            j = c0 + jl  # a live column of this rank: rows i >= j
            slab[j:, jl] -= panel[j - k - 1:] @ panel[j - k - 1].T
    return slab


def last_diag_finite(slab: torch.Tensor, mesh: Mesh) -> bool:
    """Whether the factor's last diagonal entry is finite, the JAX
    package's probe of a failed factorization, read on every rank alike."""
    probe = slab[-1, -1, -1, -1].reshape(1).clone()
    return bool(torch.isfinite(mesh.broadcast(probe, mesh.size - 1)))


def sharded_tri_solve(slab: torch.Tensor, r: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """y = (L L^T)^{-1} r over the column slabs; ``r`` (nb B,) is the same
    on every rank, and so is the returned y.

    Forward (L x = r), row by row: each rank sums its live tiles' products
    L[i,j] x_j (j < i, its columns), one all_reduce totals them, the owner
    of the diagonal applies inv(L_ii), and a second (masked) all_reduce
    gives x_i to every rank. Backward (L^T y = x), right-looking: the owner
    of column j forms y_j = inv(L_jj)^T t_j, one masked all_reduce gives it
    to every rank, and each rank subtracts L[j,i]^T y_j from t_i for its
    own columns i < j.
    """
    nb, ncl, B, _ = slab.shape
    c0 = mesh.rank * ncl
    rr = r.reshape(nb, B).to(slab.dtype)
    x = torch.zeros_like(rr)
    for i in range(nb):
        live = min(max(i - c0, 0), ncl)  # this rank's columns j < i
        if live:
            part = torch.einsum("cab,cb->a", slab[i, :live], x[c0:c0 + live])
        else:
            part = torch.zeros((B,), dtype=slab.dtype, device=slab.device)
        acc = rr[i] - mesh.all_reduce(part)
        owner = i // ncl
        xi = slab[i, i - c0] @ acc if owner == mesh.rank else torch.zeros_like(acc)
        x[i] = mesh.all_reduce(xi)
    t, y = x, torch.zeros_like(x)
    for j in range(nb - 1, -1, -1):
        owner = j // ncl
        yj = slab[j, j - c0].T @ t[j] if owner == mesh.rank else torch.zeros_like(t[j])
        y[j] = mesh.all_reduce(yj)
        live = min(max(j - c0, 0), ncl)
        if live:
            t[c0:c0 + live] -= torch.einsum("cab,a->cb", slab[j, :live], y[j])
    return y.reshape(nb * B)
