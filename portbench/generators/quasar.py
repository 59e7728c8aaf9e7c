"""QUASAR (Yang & Carlone, ICCV 2019) with N measurements.

``quasar_constraints`` is a frozen copy of
cuadmm_tpu_torch/models/quasar.py's: the structural constraints of the
relaxation over X in S^{4(N+1)} (tr X = N + 1, X_ii = X_00, every 4x4
block X_ij symmetric), with b = (N + 1) e_0 as in the reference's b.txt.
For N = 500: one 2004 block, 756,501 constraints, 1,515,004 A^T nonzeros,
the reference's quasar-500.log:4-7.

C is the paper's truncated-least-squares cost, built from measurements
that the seed draws by the paper's synthetic procedure (its data C.txt is
on neither machine): N random unit vectors a_i, a random rotation R, b_i
= R a_i + noise of deviation ``noise_sigma`` a coordinate, and a share
``outlier_share`` of the b_i replaced by random unit vectors. With q the
rotation's unit quaternion (scalar first) and the residual r_i(q) =
||b_i - R(q) a_i||^2 = q^T M_i q, the cost

    sum_i (1 + t_i)/2 r_i / beta^2 + (1 - t_i)/2 cbar2,  t_i = +-1,

is x^T C x over x = [q; t_1 q; ...; t_N q]: the block-arrow C whose
(i, i) block is M_i / (2 beta^2) + cbar2/2 I and whose (0, i) and (i, 0)
blocks are half of M_i / (2 beta^2) - cbar2/2 I, beta the
``noise_bound``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from portbench.problem import ProblemArrays

SQRT2INV = 1.0 / math.sqrt(2.0)


def _svec_idx(r: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Lower-triangle row-major svec index; requires r >= c elementwise."""
    return r * (r + 1) // 2 + c


def quasar_constraints(n_poses: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """A^T COO triplets (svec_idx, con_idx, val) for QUASAR with ``n_poses``
    = N (block dimension 4(N+1)): (at_rows, at_cols, at_vals, con_num, n),
    constraint-major, the trace constraint at row 0."""
    N = n_poses
    n = 4 * (N + 1)
    rows_parts, cols_parts, vals_parts = [], [], []
    con = 0

    # 1. tr(X) = N+1: diagonal svec entries, coefficient 1.
    d = np.arange(n, dtype=np.int64)
    rows_parts.append(_svec_idx(d, d))
    cols_parts.append(np.zeros(n, dtype=np.int64))
    vals_parts.append(np.ones(n))
    con += 1

    # 2. X_ii = X_00, i = 1..N: for each of the 10 pairs a <= b in 0..3,
    #    +1 (diag) / +1/sqrt(2) (offdiag) at X_ii's entry and the negative
    #    at X_00's; i-major, (b, a) minor.
    ab = [(a, b) for b in range(4) for a in range(b + 1)]
    a_arr = np.array([a for a, b in ab], dtype=np.int64)
    b_arr = np.array([b for a, b in ab], dtype=np.int64)
    ii = np.arange(1, N + 1, dtype=np.int64)[:, None]
    r_own = 4 * ii + b_arr[None, :]
    c_own = 4 * ii + a_arr[None, :]
    r_base = b_arr[None, :] + np.zeros_like(ii)
    c_base = a_arr[None, :] + np.zeros_like(ii)
    coeff = np.where(a_arr == b_arr, 1.0, SQRT2INV)[None, :] + np.zeros((N, 1))
    con_idx = con + np.arange(N * 10, dtype=np.int64).reshape(N, 10)
    rows_parts.append(_svec_idx(r_own, c_own).ravel())
    cols_parts.append(con_idx.ravel())
    vals_parts.append(coeff.ravel())
    rows_parts.append(_svec_idx(r_base, c_base).ravel())
    cols_parts.append(con_idx.ravel())
    vals_parts.append((-coeff).ravel())
    con += N * 10

    # 3. X_ij[a, b] = X_ij[b, a] for i < j, a < b: +1/sqrt(2) at
    #    (4j+b, 4i+a), -1/sqrt(2) at (4j+a, 4i+b).
    pairs_ij = np.array([(i, j) for j in range(1, N + 1) for i in range(j)], dtype=np.int64)
    ab2 = [(a, b) for b in range(4) for a in range(b)]
    a2 = np.array([a for a, b in ab2], dtype=np.int64)
    b2 = np.array([b for a, b in ab2], dtype=np.int64)
    i2 = pairs_ij[:, 0][:, None]
    j2 = pairs_ij[:, 1][:, None]
    P = pairs_ij.shape[0]
    con_idx2 = con + np.arange(P * 6, dtype=np.int64).reshape(P, 6)
    rows_parts.append(_svec_idx(4 * j2 + b2[None, :], 4 * i2 + a2[None, :]).ravel())
    cols_parts.append(con_idx2.ravel())
    vals_parts.append(np.full(P * 6, SQRT2INV))
    rows_parts.append(_svec_idx(4 * j2 + a2[None, :], 4 * i2 + b2[None, :]).ravel())
    cols_parts.append(con_idx2.ravel())
    vals_parts.append(np.full(P * 6, -SQRT2INV))
    con += P * 6

    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    vals = np.concatenate(vals_parts)
    order = np.lexsort((rows, cols))
    return rows[order], cols[order], vals[order], con, n


def rotation(q: np.ndarray) -> np.ndarray:
    """The rotation of the unit quaternion q = (w, v), scalar first."""
    w, v = q[0], q[1:]
    return (w * w - v @ v) * np.eye(3) + 2.0 * np.outer(v, v) + 2.0 * w * np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def residual_forms(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4, 4): M_i with q^T M_i q = ||b_i - R(q) a_i||^2 for unit q.

    b^T R(q) a = q^T S q with S = [[a.b, (a x b)^T], [a x b, a b^T + b a^T
    - (a.b) I]], and ||b - R a||^2 = |a|^2 + |b|^2 - 2 b^T R a."""
    ab = np.einsum("ij,ij->i", a, b)
    cr = np.cross(a, b)
    S = np.zeros((len(a), 4, 4))
    S[:, 0, 0] = ab
    S[:, 0, 1:] = cr
    S[:, 1:, 0] = cr
    S[:, 1:, 1:] = a[:, :, None] * b[:, None, :] + b[:, :, None] * a[:, None, :] - ab[:, None, None] * np.eye(3)
    sq = np.einsum("ij,ij->i", a, a) + np.einsum("ij,ij->i", b, b)
    return sq[:, None, None] * np.eye(4) - 2.0 * S


def measurements(params: dict, seed: int) -> tuple:
    """(a, b, q): the seed's synthetic measurements and the true rotation."""
    n = int(params["n_poses"])
    rng = np.random.default_rng(seed)
    unit = lambda m: m / np.linalg.norm(m, axis=-1, keepdims=True)  # noqa: E731
    q = unit(rng.standard_normal(4))
    a = unit(rng.standard_normal((n, 3)))
    b = a @ rotation(q).T + float(params["noise_sigma"]) * rng.standard_normal((n, 3))
    outliers = rng.choice(n, int(round(float(params["outlier_share"]) * n)), replace=False)
    b[outliers] = unit(rng.standard_normal((len(outliers), 3)))
    return a, b, q


def cost_matrix(a: np.ndarray, b: np.ndarray, noise_bound: float, cbar2: float) -> np.ndarray:
    """The dense 4(N+1) x 4(N+1) block-arrow C of the module's docstring."""
    n = len(a)
    M = residual_forms(a, b) / (2.0 * noise_bound**2)
    half = 0.5 * cbar2 * np.eye(4)
    C = np.zeros((4 * (n + 1), 4 * (n + 1)))
    blocks = C[4:, 4:].reshape(n, 4, n, 4)  # a view
    idx = np.arange(n)
    blocks[idx, :, idx, :] = M + half
    arm = ((M - half) / 2.0).transpose(1, 0, 2).reshape(4, 4 * n)  # [Q_1 ... Q_N] side by side
    C[:4, 4:] = arm
    C[4:, :4] = arm.T
    return C


def generate(params: dict, seed: int) -> ProblemArrays:
    n_poses = int(params["n_poses"])
    rows, cols, vals, con_num, n = quasar_constraints(n_poses)
    a, b, _ = measurements(params, seed)
    C = cost_matrix(a, b, float(params["noise_bound"]), float(params["cbar2"]))
    r, c = np.tril_indices(n)
    svec = C[r, c] * np.where(r == c, 1.0, np.sqrt(2.0))
    nz = np.nonzero(svec)[0]
    return ProblemArrays(
        blk=[("s", n)], con_num=con_num, At_rows=rows, At_cols=cols, At_vals=vals,
        b_indices=np.array([0]), b_vals=np.array([n_poses + 1.0]),
        C_indices=nz, C_vals=svec[nz], name=f"quasar-{n_poses}",
    )
