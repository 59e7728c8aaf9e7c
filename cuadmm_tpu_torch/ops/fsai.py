"""Factorized sparse approximate inverse (FSAI) preconditioner for CG.

The reference handles every constraint count with CHOLMOD's sparse LDLt
on the host and ships the rhs over PCIe twice per iteration (reference:
include/cuadmm/cholesky_cpu.h:62-155, src/solver.cu:487-500). A sparse
triangular solve is a serial dependency chain that keeps a GPU mostly
idle, so the normal equations that no factor mode holds (``auto`` past
dense_chol_max and the card's packed and band ceilings, ops/limits.py;
every such case on the CPU) fall to preconditioned CG, whose
preconditioner must be *matvec-shaped*. (The JAX package's reasons,
cuadmm_tpu/ops/fsai.py, are its TPU's: no pipelined triangular solve and
no host callbacks.)

FSAI is exactly that: a sparse lower-triangular G ~ inv(L) minimizing
||I - G L||_F over a fixed sparsity pattern, with G AA^T G^T ~ I; the
application is two sparse matvecs z = G^T (G r) -- a gather and a row
reduction each (ops/sparse.EllTable). Classical result (Kolotilina &
Yeremin 1993): row i of G solves the |J_i| x |J_i| dense SPD system
    (AA^T)[J_i, J_i] g = e_i,   then scales g /= sqrt(g_i)
independently per row -- an embarrassingly parallel host build (batched
np.linalg.solve over rows grouped by pattern size).

Pattern: lower triangle of a power of AA^T (default (AA^T)^2), with the
per-row nonzeros capped by |value| (keeping the diagonal). Measured on
PlanarHand N=1 (66,008 constraints, the BASELINE north star): CG to 1e-7
takes 847 iterations with Jacobi, 522 with block-Jacobi(2048), 207 with
FSAI on the AA^T pattern, 151 with FSAI on the (AA^T)^2 pattern (cap 64).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def _pattern(aat: sp.csr_matrix, power: int, cap: int) -> sp.csr_matrix:
    """Lower-triangular pattern: tril(aat^power) with per-row |value| cap.

    Row selection keeps the ``cap`` largest-|value| entries plus the
    diagonal; the *values* of the returned matrix are meaningless (only
    the sparsity pattern is used).
    """
    pat = aat
    for _ in range(power - 1):
        pat = (pat @ aat).tocsr()
    pat = sp.tril(pat, format="csr")
    if cap <= 0:
        return pat
    # Vectorized per-row top-|value| cap, grouped by row length (the old
    # all-Python row loop took minutes at the 154k-484k constraint counts
    # where cg mode actually engages, ADVICE r4). Rows at or under the cap
    # pass through untouched; each longer length class does ONE batched
    # argpartition over an (m, L) dense slab.
    n = pat.shape[0]
    indptr, indices, data = pat.indptr, pat.indices, pat.data
    sizes = np.diff(indptr)
    keep_mask = np.ones(len(indices), dtype=bool)
    for L in np.unique(sizes[sizes > cap]):
        L = int(L)
        rows = np.nonzero(sizes == L)[0]
        offs = indptr[rows][:, None] + np.arange(L)[None, :]  # (m, L)
        vals = np.abs(data[offs])
        cols = indices[offs]
        # Never drop the diagonal (it is the FSAI unit target).
        vals[cols == rows[:, None]] = np.inf
        drop = np.argpartition(vals, L - cap - 1, axis=1)[:, : L - cap]
        keep_mask[np.take_along_axis(offs, drop, axis=1).reshape(-1)] = False
    rows_np = np.repeat(np.arange(n, dtype=np.int64), sizes)[keep_mask]
    cols_np = indices[keep_mask].astype(np.int64)
    return sp.csr_matrix(
        (np.ones(len(rows_np)), (rows_np, cols_np)), shape=pat.shape
    )


def build_fsai(
    aat: sp.csr_matrix,
    eps_rel: float = 1e-8,
    pattern_power: int = 2,
    cap: int = 64,
) -> sp.csr_matrix:
    """Build the FSAI factor G (sparse lower-triangular, G AAt G^T ~ I).

    ``aat`` is the (con_num x con_num) normal matrix. ``eps_rel`` adds
    trace-scaled diagonal regularization to each local system (AA^T of
    moment SDPs is numerically singular; the local solves must not be).
    Rows are grouped by pattern size and solved with one batched
    np.linalg.solve per group.
    """
    n = aat.shape[0]
    diag = aat.diagonal()
    scale = max(float(diag.mean()), 1e-300)
    reg = eps_rel * scale
    pat = _pattern(aat, pattern_power, cap)
    indptr, indices = pat.indptr, pat.indices
    sizes = np.diff(indptr)

    # Fast exact path for k == 1 rows (pure diagonal): g = 1/sqrt(d).
    g_rows = [np.zeros(0, np.int64)]
    g_cols = [np.zeros(0, np.int64)]
    g_vals = [np.zeros(0, np.float64)]
    ones = np.nonzero(sizes == 1)[0]
    if len(ones):
        d1 = np.maximum(diag[ones] + reg, 1e-300)
        g_rows.append(ones)
        g_cols.append(indices[indptr[ones]].astype(np.int64))
        g_vals.append(1.0 / np.sqrt(d1))

    aat_c = aat.tocsr()
    for k in np.unique(sizes):
        k = int(k)
        if k <= 1:
            continue
        rows_all = np.nonzero(sizes == k)[0]
        # Bound the (m, k, k) extraction temporaries: scipy's fancy
        # element lookup materializes ~5 index/value arrays of m*k*k
        # entries; unchunked at cap=64 over 484k rows that is multi-GB
        # (ADVICE r4). ~32M elements per chunk keeps it under ~1.5 GB.
        chunk_rows = max(1, (32 << 20) // (k * k))
        for c0 in range(0, len(rows_all), chunk_rows):
            rows = rows_all[c0 : c0 + chunk_rows]
            m = len(rows)
            # J: (m, k) pattern columns per row (sorted; diagonal is last
            # since the pattern is lower-triangular with the diagonal kept).
            J = indices[(indptr[rows][:, None] + np.arange(k)[None, :])].astype(np.int64)
            # Extract the (m, k, k) local systems in one vectorized CSR
            # element lookup (scipy does a per-element binary search in C).
            ri = np.repeat(J, k, axis=1).reshape(m, k, k)  # ri[m,a,b] = J[m,a]
            ci = np.tile(J, (1, k)).reshape(m, k, k)  # ci[m,a,b] = J[m,b]
            sub = np.asarray(
                aat_c[ri.reshape(-1), ci.reshape(-1)], dtype=np.float64
            ).reshape(m, k, k)
            sub[:, np.arange(k), np.arange(k)] += reg
            e = np.zeros((m, k), np.float64)
            e[:, -1] = 1.0
            try:
                # Explicit trailing vector dim: numpy's (m,k)-shaped rhs vs a
                # (m,k,k) operand is ambiguous (matrix vs vector stack).
                g = np.linalg.solve(sub, e[..., None])[..., 0]
            except np.linalg.LinAlgError:
                # Per-row fallback for the (rare) singular locals.
                g = np.empty((m, k))
                for t in range(m):
                    try:
                        g[t] = np.linalg.solve(sub[t], e[t])
                    except np.linalg.LinAlgError:
                        g[t] = 0.0
                        g[t, -1] = 1.0 / max(sub[t, -1, -1], 1e-300)
            gi = g[:, -1].copy()
            # Rows whose local solve went negative/zero on the diagonal fall
            # back to the Jacobi row (diagonal-only).
            bad = ~(gi > 0)
            if bad.any():
                g[bad] = 0.0
                dj = np.maximum(diag[rows[bad]] + reg, 1e-300)
                g[bad, -1] = 1.0 / dj
                gi[bad] = g[bad, -1]
            g /= np.sqrt(gi)[:, None]
            g_rows.append(np.repeat(rows, k))
            g_cols.append(J.reshape(-1))
            g_vals.append(g.reshape(-1))

    G = sp.csr_matrix(
        (np.concatenate(g_vals), (np.concatenate(g_rows), np.concatenate(g_cols))),
        shape=(n, n),
    )
    G.sum_duplicates()
    return G


def fsai_tables(G: sp.csr_matrix, dtype, device) -> Tuple[object, object]:
    """(G, G^T) as bucketed-ELL matvec tables (ops/sparse.EllTable) on
    ``device``."""
    from cuadmm_tpu_torch.ops.sparse import _build_ell

    n = G.shape[0]
    coo = G.tocoo()
    g_tbl = _build_ell(
        coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data, n, n, dtype, device
    )
    gt_tbl = _build_ell(
        coo.col.astype(np.int64), coo.row.astype(np.int64), coo.data, n, n, dtype, device
    )
    return g_tbl, gt_tbl
