"""Reference-signature compatibility shim.

Mirrors the reference's MEX entry point argument order
(reference: MATLAB/cuadmm_MATLAB.cu:197-433, README.md "MATLAB Bindings"):

    cuadmm_MATLAB(eig_stream_num, max_iter, stop_tol,
                  At_stack, b, C_stack, blk_vec,
                  X_new, y_new, S_new, sig_new)

so existing cuADMM callers can switch with minimal glue. Returns numpy
(X, y, S, info) where info matches the MEX 10-row info cell:
{iter_num, pobj_arr, dobj_arr, errRp_arr, errRd_arr, relgap_arr, sig_arr,
 bscale_arr, Cscale_arr, total_time}. Solves on ``device`` ("cuda" unless
the caller asks for the CPU; an absent card raises).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.problem import Problem
from cuadmm_tpu_torch.solver.driver import SDPSolver


def cuadmm(
    eig_stream_num: int,  # ignored, as in the JAX package (kept for signature parity)
    max_iter: int,
    stop_tol: float,
    At,  # scipy sparse or dense (vec_len x con_num) svec-stacked A^T
    b,
    C,
    blk_vec: Sequence[int],
    X0: Optional[np.ndarray] = None,
    y0: Optional[np.ndarray] = None,
    S0: Optional[np.ndarray] = None,
    sig: float = 2e2,
    device="cuda",
    **config_kw,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
    At = sp.coo_matrix(At)
    b = np.asarray(b, dtype=np.float64).ravel()
    C = np.asarray(C, dtype=np.float64).ravel()
    con_num = At.shape[1]
    blk = [("s", int(n)) for n in np.asarray(blk_vec).ravel()]

    rows = At.row.astype(np.int32)
    cols = At.col.astype(np.int32)
    vals = At.data.astype(np.float64)
    order = np.lexsort((rows, cols))
    b_idx = np.nonzero(b)[0].astype(np.int32)
    C_idx = np.nonzero(C)[0].astype(np.int32)
    prob = Problem(
        blk=blk,
        con_num=con_num,
        At_rows=rows[order],
        At_cols=cols[order],
        At_vals=vals[order],
        b_indices=b_idx,
        b_vals=b[b_idx],
        C_indices=C_idx,
        C_vals=C[C_idx],
        name="compat",
    )
    cfg = SolverConfig(max_iter=int(max_iter), stop_tol=float(stop_tol), **config_kw)
    res = SDPSolver(prob, cfg, device=device).solve(X0=X0, y0=y0, S0=S0, sig=sig)
    info = {
        "iter_num": res.iterations,
        "pobj_arr": res.info["pobj"],
        "dobj_arr": res.info["dobj"],
        "errRp_arr": res.info["errRp"],
        "errRd_arr": res.info["errRd"],
        "relgap_arr": res.info["relgap"],
        "sig_arr": res.info["sig"],
        "bscale_arr": res.info["bscale"],
        "Cscale_arr": res.info["Cscale"],
        "total_time": res.total_time,
    }
    return res.X, res.y, res.S, info
