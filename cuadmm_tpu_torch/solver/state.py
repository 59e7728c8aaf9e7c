"""Solver state and solve parameters.

Port of cuadmm_tpu/solver/state.py: plain dataclasses of tensors. Scalars
are 0-d tensors on the solver's device, so an iteration never waits for
the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from cuadmm_tpu_torch.ops.chol import NormalEqSolver
from cuadmm_tpu_torch.ops.sparse import SparseA


@dataclasses.dataclass
class SolverState:
    """Everything that evolves across iterations (scaled space).

    Scalar metrics (errRp/errRd/pobj/dobj/relgap) are in original
    (unscaled) units, as in the reference's info arrays.
    """

    X: torch.Tensor
    y: torch.Tensor
    S: torch.Tensor
    SmC: torch.Tensor  # S - C cache
    Rp: torch.Tensor  # b - A X cache
    sig: torch.Tensor
    errRp: torch.Tensor
    errRd: torch.Tensor
    pobj: torch.Tensor
    dobj: torch.Tensor
    relgap: torch.Tensor
    maxfeas: torch.Tensor
    prim_win: torch.Tensor  # int32
    dual_win: torch.Tensor  # int32
    it: torch.Tensor  # int32, completed iterations
    sig_stage_2: torch.Tensor  # int32, halved at the ADMM switch
    sigscale: torch.Tensor  # scaled by 1.23 at the switch
    best_kkt: torch.Tensor
    X_best: torch.Tensor
    y_best: torch.Tensor
    S_best: torch.Tensor


@dataclasses.dataclass
class SolveParams:
    """Problem-constant device data used by every step."""

    sparse_a: SparseA
    maps: Dict[str, Any]
    neq: NormalEqSolver
    b: torch.Tensor  # dense, scaled
    C: torch.Tensor  # pool coordinates, scaled
    normA: torch.Tensor
    bscale: torch.Tensor
    Cscale: torch.Tensor
    objscale: torch.Tensor
    norm_borg: torch.Tensor
    norm_Corg: torch.Tensor


# Info row layout (reference info arrays: include/cuadmm/solver.h:148-156).
INFO_FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig", "bscale", "Cscale")
