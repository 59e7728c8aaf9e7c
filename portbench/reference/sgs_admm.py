"""Plain sGS-ADMM in float64: the reference the program's solves are held to.

The algorithm is the reference cuADMM's solve loop (src/solver.cu:415-811),
written out again in plain torch from its description: A's rows scaled to
unit norm (those above 1), b and C scaled (src/solver.cu:167-191), and
from the cold start X = y = S = 0 each iteration

  1. y' = (AA^T)^{-1} (Rp/sig - A(S - C));  Rd1 = A^T y' - C
  2. S = (Pi(X + sig Rd1) - X)/sig - Rd1, Pi the projection onto the cone
  3. in sGS (iteration < switch_admm) a second solve y = (AA^T)^{-1}
     (Rp/sig - A(S - C)), Rd1 = A^T y - C; else y = y' and the best
     iterate is tracked
  4. X += tau sig (Rd1 + S), tau 1.95 in sGS and 1.618 in ADMM
  5. the residuals, the objectives, the prim/dual vote and sigma's update.

Nothing here comes from the program: the normal equations are solved
directly, through the float64 Cholesky inverse of each connected block of
AA^T with one refinement step, and the projection goes through each
block's eigendecomposition (``numpy.linalg.eigh`` or
``torch.linalg.eigh``). The scalars that steer the iteration (sigma, the votes, tau) live on the
host as Python floats.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch

from portbench.problem import ProblemArrays

F64 = torch.float64
TAU_SGS = 1.95
TAU_ADMM = 1.618
SWITCH_SIGSCALE_BOOST = 1.23
# Rows of AA^T in one connected block that the dense inverse takes:
# 40,000 rows hold 12.8 GB a square.
MAX_DENSE_ROWS = 40_000
# PSD blocks up to this size go through numpy's batched eigh on the host:
# torch.linalg.eigh took 39 ms for the 1,556 5x5 blocks of
# chordal_maxcut_1560 on an H100, numpy takes about 2.
HOST_EIGH_MAX = 64
INFO_FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig", "bscale", "Cscale")


def _csr(rows, cols, vals, shape, device) -> torch.Tensor:
    m = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    m.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64), torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data, dtype=F64), size=shape, device=device)


class NormalSolve:
    """y = (A A^T)^{-1} r for the row-scaled A (con_num x vec_len): AA^T
    formed on the host (scipy), split into its connected blocks, and each
    block inverted densely in float64 through its Cholesky factor; blocks
    of one size are stacked and applied as one batched product. One
    refinement step against the sparse A follows."""

    def __init__(self, A_host: sp.csr_matrix, A: torch.Tensor, At: torch.Tensor, device):
        self.A, self.At = A, At
        G = (A_host @ A_host.T).tocoo()
        _, labels = csgraph.connected_components(G, directed=False)
        sizes = np.bincount(labels)
        if sizes.max() > MAX_DENSE_ROWS:
            raise NotImplementedError(f"a coupled block of {sizes.max()} rows: past the dense reference's "
                                      f"{MAX_DENSE_ROWS}")
        order = np.argsort(labels, kind="stable")  # rows grouped by block
        starts = np.concatenate([[0], np.cumsum(sizes)])
        pos = np.empty(len(labels), dtype=np.int64)  # a row's place in its block
        pos[order] = np.arange(len(labels)) - starts[labels[order]]
        self.groups: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for k in np.unique(sizes):
            blocks = np.nonzero(sizes == k)[0]
            slot = np.full(len(sizes), -1, dtype=np.int64)
            slot[blocks] = np.arange(len(blocks))
            sel = sizes[labels[G.row]] == k
            gram = np.zeros((len(blocks), k, k))
            gram[slot[labels[G.row[sel]]], pos[G.row[sel]], pos[G.col[sel]]] = G.data[sel]
            chol = torch.linalg.cholesky(torch.as_tensor(gram, device=device))
            rows = order[starts[blocks][:, None] + np.arange(k)[None, :]]
            self.groups.append((torch.as_tensor(rows, device=device), torch.cholesky_inverse(chol)))

    def _apply(self, r: torch.Tensor) -> torch.Tensor:
        y = torch.empty_like(r)
        for rows, inv in self.groups:
            y[rows] = (inv @ r[rows].unsqueeze(-1)).squeeze(-1)
        return y

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        y = self._apply(r)
        return y + self._apply(r - self.A @ (self.At @ y))


class Projection:
    """Pi onto the product cone in svec coordinates: each PSD block through
    its eigendecomposition (blocks of one size batched; up to HOST_EIGH_MAX
    rows ``numpy.linalg.eigh`` on the host, past it ``torch.linalg.eigh``
    on the device), 1x1 blocks clamped at 0, free ('u') blocks unchanged."""

    def __init__(self, blk, device):
        self.device = device
        by_size: Dict[int, List[int]] = {}
        scalar: List[int] = []
        off = 0
        for kind, n in blk:
            if kind == "s" and n > 1:
                by_size.setdefault(n, []).append(off)
            elif kind == "s":
                scalar.append(off)
            elif kind != "u":
                raise ValueError(f"unknown block type {kind!r}")
            off += n * (n + 1) // 2 if kind == "s" else n
        self.scalar_pos = torch.as_tensor(scalar, dtype=torch.int64, device=device)
        self.groups = []
        for n, offs in sorted(by_size.items()):
            r, c = np.tril_indices(n)
            local = r * (r + 1) // 2 + c
            full = np.zeros((n, n), dtype=np.int64)
            full[r, c] = local
            full[c, r] = local
            offs_t = np.asarray(offs, dtype=np.int64)
            g = dict(host=n <= HOST_EIGH_MAX, n=n, gather=offs_t[:, None, None] + full[None],
                     scale=np.where(np.eye(n, dtype=bool), 1.0, 1.0 / math.sqrt(2.0)), tril=(r, c),
                     svec_scale=np.where(r == c, 1.0, math.sqrt(2.0)), pos=offs_t[:, None] + local[None])
            if not g["host"]:
                for key in ("gather", "scale", "svec_scale", "pos"):
                    g[key] = torch.as_tensor(g[key], device=device)
                g["tril"] = tuple(torch.as_tensor(t, device=device) for t in g["tril"])
            self.groups.append(g)
        self.host_pos = [g["pos"] for g in self.groups if g["host"]]
        self.host_pos_t = (torch.as_tensor(np.concatenate([p.ravel() for p in self.host_pos]), device=device)
                           if self.host_pos else None)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        if len(self.scalar_pos):
            out[self.scalar_pos] = torch.clamp(x[self.scalar_pos], min=0.0)
        xh = x.cpu().numpy() if self.host_pos_t is not None else None
        host_out = []
        for g in self.groups:
            r, c = g["tril"]
            if g["host"]:
                w, v = np.linalg.eigh(xh[g["gather"]] * g["scale"])
                proj = (v * np.maximum(w, 0.0)[..., None, :]) @ np.swapaxes(v, -1, -2)
                host_out.append((proj[:, r, c] * g["svec_scale"]).ravel())
            else:
                w, v = torch.linalg.eigh(x[g["gather"]] * g["scale"])
                proj = (v * torch.clamp(w, min=0.0).unsqueeze(-2)) @ v.mT
                out[g["pos"]] = proj[:, r, c] * g["svec_scale"]
        if host_out:
            out[self.host_pos_t] = torch.as_tensor(np.concatenate(host_out), device=self.device)
        return out


class Reference:
    """Solves of one problem under the algorithm parameters of a
    configuration's ``solver`` settings (sig, sig_update_threshold,
    sig_update_stage_1, sig_update_stage_2, sigscale, sig_min, sig_max,
    switch_admm), in float64 on ``device``."""

    def __init__(self, prob: ProblemArrays, settings: dict, device):
        self.settings = settings
        self.device = torch.device(device)
        con_num, vec_len = prob.con_num, prob.vec_len
        con = np.asarray(prob.At_cols, dtype=np.int64)
        vec = np.asarray(prob.At_rows, dtype=np.int64)
        vals = np.asarray(prob.At_vals, dtype=np.float64)
        self.normA = np.maximum(1.0, np.sqrt(np.bincount(con, weights=vals * vals, minlength=con_num)))
        vals = vals / self.normA[con]
        b, C = prob.dense_b(), prob.dense_C()
        self.norm_borg = 1.0 + float(np.linalg.norm(b))
        self.norm_Corg = 1.0 + float(np.linalg.norm(C))
        b = b / self.normA
        self.bscale = 1.0 + float(np.linalg.norm(b))
        self.Cscale = 1.0 + float(np.linalg.norm(C))
        self.objscale = self.bscale * self.Cscale
        dev = self.device
        self.b = torch.as_tensor(b / self.bscale, dtype=F64, device=dev)
        self.C = torch.as_tensor(C / self.Cscale, dtype=F64, device=dev)
        self.normA_t = torch.as_tensor(self.normA, dtype=F64, device=dev)
        with warnings.catch_warnings():  # torch calls its sparse CSR tensors beta
            warnings.simplefilter("ignore")
            self.A = _csr(con, vec, vals, (con_num, vec_len), dev)
            self.At = _csr(vec, con, vals, (vec_len, con_num), dev)
        A_host = sp.csr_matrix((vals, (con, vec)), shape=(con_num, vec_len))
        self.solve_aat = NormalSolve(A_host, self.A, self.At, dev)
        self.project = Projection(prob.blk, dev)

    def solve(self, max_iter: int, stop_tol: float) -> dict:
        """A solve from the cold start: the unscaled X, y, S, the info rows
        (one per iteration, INFO_FIELDS) and the iterations run."""
        s = self.settings
        A, At, b, C = self.A, self.At, self.b, self.C
        switch_admm = int(s["switch_admm"])
        sig = float(s["sig"])
        sigscale = float(s["sigscale"])
        sig_stage_2 = int(s["sig_update_stage_2"])
        X = torch.zeros_like(C)
        y = torch.zeros_like(b)
        S = torch.zeros_like(C)
        SmC = S - C
        Rp = b - A @ X
        errRp = float(torch.linalg.norm(self.normA_t * Rp)) * self.bscale / self.norm_borg
        errRd = float(torch.linalg.norm(At @ y + SmC)) * self.Cscale / self.norm_Corg
        pobj = dobj = 0.0
        relgap = 0.0
        prim_win = dual_win = 0
        best_kkt = math.inf
        best = None
        rows = []
        diverged = False
        for k in range(max_iter):
            it = k + 1
            sgs = it < switch_admm
            y_half = self.solve_aat(Rp / sig - A @ SmC)
            Rd1 = At @ y_half - C
            S = (self.project(X + sig * Rd1) - X) / sig - Rd1
            SmC = S - C
            if sgs:
                y = self.solve_aat(Rp / sig - A @ SmC)
                Rd1 = At @ y - C
            else:
                y = y_half
            kkt_entry = max(errRp, errRd, relgap)
            if it == switch_admm:
                sig_stage_2 //= 2
                sigscale *= SWITCH_SIGSCALE_BOOST
            if it == switch_admm or (it > switch_admm and best_kkt > kkt_entry):
                best_kkt = kkt_entry
                best = (X, y, S)
            Rd = Rd1 + S
            tau = TAU_SGS if sgs else TAU_ADMM
            if errRd < stop_tol:
                tau = max(TAU_ADMM, tau / 1.1)
            X = X + (tau * sig) * Rd
            Rp = b - A @ X
            errRp = float(torch.linalg.norm(self.normA_t * Rp)) * self.bscale / self.norm_borg
            errRd = float(torch.linalg.norm(Rd)) * self.Cscale / self.norm_Corg
            pobj = float(torch.dot(C, X)) * self.objscale
            dobj = float(torch.dot(b, y)) * self.objscale
            relgap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
            with np.errstate(divide="ignore", invalid="ignore"):
                prim_better = bool(np.float64(errRp) / np.float64(errRd) < 1.0)
            prim_win += prim_better
            dual_win += not prim_better
            thr = int(s["sig_update_threshold"])
            do_update = it % int(s["sig_update_stage_1"]) == 1 if it <= thr else it % sig_stage_2 == 1
            prim_dom = prim_win > 1.2 * dual_win
            dual_dom = dual_win > 1.2 * prim_win
            if do_update and prim_dom:
                sig = min(sig * sigscale, float(s["sig_max"]))
                prim_win = 0
            elif do_update and dual_dom:
                sig = max(sig / sigscale, float(s["sig_min"]))
                dual_win = 0
            rows.append((pobj, dobj, errRp, errRd, relgap, sig, self.bscale, self.Cscale))
            kkt = max(errRp, errRd, relgap)
            if not math.isfinite(kkt):
                diverged = True
                break
            if kkt < stop_tol:
                break
        if len(rows) > switch_admm and math.isfinite(best_kkt):
            X, y, S = best
        return dict(
            X=(X * self.bscale).cpu().numpy(),
            y=(y / self.normA_t * self.Cscale).cpu().numpy(),
            S=(S * self.Cscale).cpu().numpy(),
            info=np.asarray(rows, dtype=np.float64).reshape(-1, len(INFO_FIELDS)),
            iterations=len(rows),
            diverged=diverged,
        )
