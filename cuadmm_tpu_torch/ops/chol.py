"""Normal-equation solver for (A A^T) y = rhs, precond mode.

Port of the precond mode of cuadmm_tpu/ops/chol.py. At init, AA^T plus a
relative diagonal regularization eps is factorized once in f32 on the
device (eps escalates x10 until the factor is finite), and the triangular
factor is inverted explicitly and zero-padded: M = inv(L). Each solve runs
``applies`` refinement sweeps

    y <- y + M^T M (rhs - A (A^T y))

with the residual accumulated in f64 through the exact sparse A, and
M^T M r applied by the fused kernel K1 (ops/precond_apply.py). The rhs of
every ADMM solve lies in range(A), so each sweep contracts the residual by
about eps even where AA^T is numerically singular.

The JAX package takes this route only on an accelerator (on the CPU it
keeps the factor in the state dtype and solves with cho_solve); the port
takes it on every device, so the CPU tests run the card's code except the
kernel itself. The other modes are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch.device import synchronize
from cuadmm_tpu_torch.ops.precond_apply import fused_spd_apply, pad_factor
from cuadmm_tpu_torch.ops.sparse import SparseA, aat_matvec

_NOT_PORTED = {
    "dense": "Normal solver: dense and split modes",
    "split": "Normal solver: dense and split modes",
    "packed": "Packed and banded normal solvers",
    "banded": "Packed and banded normal solvers",
    "sharded": "Several devices",
    "cg": "CG, FSAI, block-Jacobi and host modes",
    "host": "CG, FSAI, block-Jacobi and host modes",
}


def _not_ported(mode: str) -> NotImplementedError:
    return NotImplementedError(
        f"normal_solver={mode!r} is not ported yet (ROADMAP.md queue 1: "
        f"{_NOT_PORTED[mode]!r}); the port has normal_solver='precond'"
    )


# Calibration of the sweep count: the relative residual the f64 refinement
# must beat, and the most sweeps tried.
CALIBRATE_TARGET = 1e-10
CALIBRATE_MAX_APPLIES = 6


@dataclasses.dataclass
class NormalEqSolver:
    """Precond-mode solver: the padded f32 inverse factor and the f64 A."""

    mode: str
    inv_l: torch.Tensor  # (n_pad, n_pad) f32, zero-padded inv(L)
    sparse_a: SparseA  # f64, for the refinement residuals
    applies: int = 2  # refinement sweeps per solve
    eps_used: float = 0.0

    def _sweep(self, rhs: torch.Tensor, y: torch.Tensor, r_pad: torch.Tensor) -> torch.Tensor:
        """One refinement sweep: y + M^T M (rhs - AA^T y), in f64 but for K1.

        ``r_pad`` is an (n_pad,) f32 buffer whose tail past con_num stays
        zero: the f64 residual is rounded into its head in one kernel, K1
        reads the buffer as it is, and its f32 result is added to the f64 y
        in one more. M^T M approximates (AA^T + eps I)^{-1} with error
        ~ cond(L) * eps32 = sqrt(cond(P)) * eps32, which the sweeps contract
        against the exact AA^T.
        """
        n = y.shape[0]
        torch.sub(rhs, aat_matvec(self.sparse_a, y), out=r_pad[:n])
        return y + fused_spd_apply(self.inv_l, r_pad)[:n]

    def solve(self, rhs: torch.Tensor, warm: Optional[torch.Tensor] = None) -> torch.Tensor:
        # Refinement through the composed A (A^T y): its rounding stays in
        # range(A), which the regularized factor does not amplify.
        hp = torch.float64
        rhs_hp = rhs.to(hp)
        y = torch.zeros_like(rhs_hp) if warm is None else warm.to(hp)
        r_pad = self.inv_l.new_zeros(self.inv_l.shape[0])
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
    dev = neq.inv_l.device
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(con_num), dtype=torch.float64, device=dev)
    rhs = aat_matvec(sa, v)
    y = torch.zeros_like(rhs)
    r_pad = neq.inv_l.new_zeros(neq.inv_l.shape[0])
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
    timings: Optional[Dict[str, float]] = None,
) -> NormalEqSolver:
    """Factorize once at init and return a device-resident solver.

    ``mode="auto"`` resolves as the JAX package does on an accelerator
    (cuadmm_tpu/ops/chol.py:781-801), with the CPU's size guards when
    ``device`` is the CPU. Every mode but ``precond`` raises
    ``NotImplementedError``. ``sparse_a`` is the f64 A of the refinement.
    ``timings``, when given, receives the wall seconds of each stage.
    """
    on_accel = device.type == "cuda"
    cpu_max_factor_bytes = 2**31 - 1
    if mode == "inv":  # legacy alias
        mode = "precond"
    if mode == "auto":
        # Coupled rows: constraints sharing an svec column with another.
        col_mult = np.bincount(at_svec_idx, minlength=vec_len)
        shared = col_mult[at_svec_idx] >= 2
        n_coupled = len(np.unique(at_con_idx[shared]))
        split_fits_cpu = on_accel or n_coupled * n_coupled * 4 <= cpu_max_factor_bytes
        if n_coupled <= min(dense_chol_max, max(con_num // 2, 1024)) and split_fits_cpu:
            mode = "split"
        elif con_num <= dense_chol_max:
            mode = "precond" if (on_accel or dtype == torch.float32) else "dense"
        else:
            raise NotImplementedError(
                f"con_num={con_num} > dense_chol_max={dense_chol_max}: the JAX package "
                "picks packed, banded, sharded or cg here, none of them ported yet "
                "(ROADMAP.md queue 1: 'Packed and banded normal solvers')"
            )
    if mode != "precond":
        raise _not_ported(mode) if mode in _NOT_PORTED else ValueError(f"unknown normal_solver {mode!r}")
    if con_num > dense_chol_max:
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

    l, eps_used = _device_factorize(
        at_svec_idx, at_con_idx, vals, con_num, vec_len, max(precond_eps, 1e-5), device
    )
    mark("factorize")
    inv_l = pad_factor(_tri_inv(l))
    del l  # only the inverse is kept: frees n^2 of device memory
    mark("tri_inv")
    neq = NormalEqSolver(
        mode="precond", inv_l=inv_l, sparse_a=sparse_a, applies=max(applies, 1), eps_used=eps_used
    )
    if applies <= 0:
        neq = _calibrate_applies(neq, con_num)
    mark("calibrate")
    return neq
