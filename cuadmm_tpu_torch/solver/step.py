"""One sGS-ADMM iteration and the chunk runner.

Port of cuadmm_tpu/solver/step.py. The algorithm and its constants follow
the reference solve loop (src/solver.cu:415-811):

  1. rhs = Rp/sig - A(S - C);  y_half = (AA^T)^{-1} rhs
  2. Rd1 = A^T y_half - C;  Xb = X + sig*Rd1;  S = (Pi(Xb) - Xb)/sig
  3. second normal-equation solve while in sGS mode (it < switch_admm);
     best-iterate tracking after the switch
  4. X += tau*sig*(Rd1 + S), tau = 1.95 (sGS) / 1.618 (ADMM)
  5. residuals, objectives, prim/dual vote, sigma re-balancing

A chunk of steps runs with no host sync of its own, so the done guard is a
device-side select over every state field.

The state may carry a leading instance axis (``parallel/batch.py``): vector
fields (B, length), scalars (B,), the parameters b and C per instance and
the scalings (B,). Reductions run over the last axis and per-instance
scalars broadcast through ``_col``; with no instance axis every op is the
one-instance op.

Over a rank mesh (``mesh``) the projection splits its buckets over the
ranks (ops/projection.py); everything else runs whole on every rank, on
identical inputs, so the ranks' states stay bitwise equal
(parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from cuadmm_tpu_torch.ops.projection import psd_project_pool
from cuadmm_tpu_torch.ops.sparse import SparseA, spmv_a, spmv_at
from cuadmm_tpu_torch.parallel.mesh import Mesh
from cuadmm_tpu_torch.solver.state import SolveParams, SolverState

TAU_SGS = 1.95  # reference: src/solver.cu:748
TAU_ADMM = 1.618  # reference: src/solver.cu:750
SWITCH_SIGSCALE_BOOST = 1.23  # reference: src/solver.cu:684
_SEG = 2048


def _seg_dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis of per-segment partial sums, the
    partials reduced in f64. In f32 state this keeps the objectives free of
    a length-dependent accumulation floor (cuadmm_tpu/solver/step.py:167-
    180)."""
    n = u.shape[-1]
    k = -(-n // _SEG)
    pad = k * _SEG - n
    if pad:
        u = torch.nn.functional.pad(u, (0, pad))
        v = torch.nn.functional.pad(v, (0, pad))
    parts = torch.sum(u.reshape(u.shape[:-1] + (k, _SEG)) * v.reshape(v.shape[:-1] + (k, _SEG)), dim=-1)
    return torch.sum(parts.to(torch.float64), dim=-1)


def _col(t: torch.Tensor) -> torch.Tensor:
    """A per-instance scalar (B,) as a (B, 1) column against (B, length)
    fields; a 0-d scalar as it is."""
    return t.unsqueeze(-1) if t.dim() else t


def _select(cond: torch.Tensor, a: SolverState, b: SolverState) -> SolverState:
    """Field-wise ``torch.where(cond, a, b)``; ``cond`` per instance."""
    out = {}
    for f in dataclasses.fields(SolverState):
        x = getattr(a, f.name)
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        out[f.name] = torch.where(c, x, getattr(b, f.name))
    return SolverState(**out)


def make_step(
    stop_tol: float,
    switch_admm: int,
    sig_update_threshold: int,
    sig_update_stage_1: int,
    sig_min: float,
    sig_max: float,
    eig_rank: Optional[int] = None,
    projection: Union[str, Dict[int, str]] = "eigh",
    rp_hp: Optional[Tuple[SparseA, torch.Tensor, torch.Tensor]] = None,
    mesh: Optional[Mesh] = None,
):
    """Build ``step(state, params, it_host) -> (state, info_row)``.

    ``projection`` is one method for every bucket or the per-bucket dict of
    the calibrated dispatch; it goes to ``psd_project_pool`` unchanged.

    ``rp_hp``: optional (sparse_a_f64, b_f64, normA_f64). When given, Rp
    and errRp come from the f64 A-product of the iterate and Rp is then
    rounded to the state dtype (cuadmm_tpu/solver/step.py:60-85, 148-163):
    in f32 state the measured errRp floors near 1e-7 ||A|| ||X|| and biases
    the sigma vote, so the driver switches it on after a precision stall.

    ``mesh``: the rank mesh the projection's buckets are split over (None:
    one device). The pool vectors stay whole on every rank, where the JAX
    step places them on the mesh (cuadmm_tpu/solver/step.py:109-110, 145;
    parallel/mesh.py says why).

    ``it_host`` is the host's count of the iterations ``state`` has
    completed. It picks the sGS or ADMM branch on the host, where the JAX
    package has a device-side cond. That is exact: the count equals
    ``state.it`` until the done guard engages, and from then on the guard
    returns the old state whichever branch ran.
    """

    def step(state: SolverState, params: SolveParams, it_host: int) -> Tuple[SolverState, torch.Tensor]:
        sa = params.sparse_a
        it = state.it + 1  # 1-based iteration number
        sig = state.sig
        sig_c = _col(sig)

        # -- Step 1: first normal-equation solve -------------------------
        rhsy = state.Rp / sig_c - spmv_a(sa, state.SmC)
        y_half = params.neq.solve(rhsy, warm=state.y)

        # -- Step 2: PSD projection --------------------------------------
        Rd1 = spmv_at(sa, y_half) - params.C
        Xb = state.X + sig_c * Rd1
        Xproj = psd_project_pool(Xb, params.maps, eig_rank=eig_rank, method=projection, mesh=mesh)
        S = (Xproj - state.X) / sig_c - Rd1
        SmC = S - params.C

        # -- Step 3: sGS second solve / best tracking --------------------
        in_sgs = it_host + 1 < switch_admm
        if in_sgs:
            rhsy2 = state.Rp / sig_c - spmv_a(sa, SmC)
            y_new = params.neq.solve(rhsy2, warm=y_half)
            Rd1_new = spmv_at(sa, y_new) - params.C
        else:
            y_new, Rd1_new = y_half, Rd1

        # Switch bookkeeping (reference: src/solver.cu:681-741); the KKT
        # metric compared is the previous iteration's, as in the reference.
        kkt_entry = torch.maximum(state.maxfeas, state.relgap)
        at_switch = it == switch_admm
        sig_stage_2 = torch.where(at_switch, state.sig_stage_2 // 2, state.sig_stage_2)
        sigscale = torch.where(at_switch, state.sigscale * SWITCH_SIGSCALE_BOOST, state.sigscale)
        take_best = at_switch | ((it > switch_admm) & (state.best_kkt > kkt_entry))
        best_kkt = torch.where(take_best, kkt_entry, state.best_kkt)
        take_best_c = _col(take_best)
        X_best = torch.where(take_best_c, state.X, state.X_best)
        y_best = torch.where(take_best_c, y_new, state.y_best)
        S_best = torch.where(take_best_c, S, state.S_best)

        # -- Step 4: primal update ---------------------------------------
        Rd = Rd1_new + S
        tau0 = TAU_SGS if in_sgs else TAU_ADMM
        tau = torch.where(
            state.errRd < stop_tol, sig.new_full((), max(TAU_ADMM, tau0 / 1.1)), tau0
        )
        X = state.X + _col(tau * sig) * Rd

        # -- Step 5: residuals, objectives, sigma ------------------------
        if rp_hp is not None:
            sa64, b64, normA64 = rp_hp
            Rp64 = b64 - spmv_a(sa64, X.to(b64.dtype))
            Rp = Rp64.to(X.dtype)
            errRp = torch.linalg.norm(normA64 * Rp64, dim=-1).to(X.dtype) * params.bscale / params.norm_borg
        else:
            Rp = params.b - spmv_a(sa, X)
            errRp = torch.linalg.norm(params.normA * Rp, dim=-1) * params.bscale / params.norm_borg
        errRd = torch.linalg.norm(Rd, dim=-1) * params.Cscale / params.norm_Corg
        pobj = (_seg_dot(params.C, X) * params.objscale).to(X.dtype)
        dobj = (_seg_dot(params.b, y_new) * params.objscale).to(X.dtype)
        maxfeas = torch.maximum(errRp, errRd)
        relgap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))

        prim_better = errRp / errRd < 1.0  # ratioconst = 1 (solver.cu:325)
        prim_win = state.prim_win + prim_better.to(torch.int32)
        dual_win = state.dual_win + (~prim_better).to(torch.int32)

        do_update = torch.where(
            it <= sig_update_threshold,
            it % sig_update_stage_1 == 1,
            it % sig_stage_2 == 1,
        )
        prim_dominates = prim_win > 1.2 * dual_win.to(torch.float64)
        dual_dominates = dual_win > 1.2 * prim_win.to(torch.float64)
        sig_up = do_update & prim_dominates
        sig_down = do_update & ~prim_dominates & dual_dominates
        sig_new = torch.where(sig_up, torch.clamp(sig * sigscale, max=sig_max), sig)
        sig_new = torch.where(sig_down, torch.clamp(sig / sigscale, min=sig_min), sig_new)
        prim_win = torch.where(sig_up, 0, prim_win)
        dual_win = torch.where(sig_down, 0, dual_win)

        new_state = SolverState(
            X=X,
            y=y_new,
            S=S,
            SmC=SmC,
            Rp=Rp,
            sig=sig_new,
            errRp=errRp,
            errRd=errRd,
            pobj=pobj,
            dobj=dobj,
            relgap=relgap,
            maxfeas=maxfeas,
            prim_win=prim_win,
            dual_win=dual_win,
            it=it,
            sig_stage_2=sig_stage_2,
            sigscale=sigscale,
            best_kkt=best_kkt,
            X_best=X_best,
            y_best=y_best,
            S_best=S_best,
        )
        done = torch.maximum(state.maxfeas, state.relgap) < stop_tol
        new_state = _select(done, state, new_state)
        info_row = torch.stack(
            [
                new_state.pobj,
                new_state.dobj,
                new_state.errRp,
                new_state.errRd,
                new_state.relgap,
                new_state.sig,
                params.bscale,
                params.Cscale,
            ],
            dim=-1,
        )
        return new_state, info_row

    return step


def run_chunk(step, state: SolverState, params: SolveParams, it_host: int, chunk: int):
    """Run ``chunk`` steps from ``state`` (which has completed ``it_host``
    iterations); returns the new state and the (chunk, 8) info rows
    ((chunk, B, 8) for a batch), both still on the device."""
    rows = []
    for k in range(chunk):
        state, row = step(state, params, it_host + k)
        rows.append(row)
    return state, torch.stack(rows)
