"""Carry the JAX package's solver objects over to the port.

Each function takes one of ``cuadmm_tpu``'s objects (SolverState,
SolveParams, SparseA/EllTable, the ``device_maps`` dict, a precond, packed or
banded NormalEqSolver) whose array fields are numpy arrays or anything
``np.asarray`` reads, and returns the port's counterpart on ``device``.
So one step of each package can start from identical state. This module
never imports jax: it only reads attributes and converts arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cuadmm_tpu_torch.ops.chol import NormalEqSolver, _tri_inv
from cuadmm_tpu_torch.ops.precond_apply import pad_factor
from cuadmm_tpu_torch.ops.sparse import EllTable, SparseA
from cuadmm_tpu_torch.solver.state import SolveParams, SolverState


def _tensor(x, device) -> torch.Tensor:
    """Array -> tensor owning a copy; integer arrays become int64 index
    tensors, except 0-d counters, which keep their dtype (the state's int32
    scalars)."""
    a = np.array(x)
    if a.dtype.kind in "iu" and a.ndim > 0:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def _opt(x, device):
    return None if x is None else _tensor(x, device)


def ell_table_from_numpy(t, device) -> EllTable:
    return EllTable(
        idx=tuple(_tensor(i, device) for i in t.idx),
        vals=tuple(_tensor(v, device) for v in t.vals),
        out_perm=_opt(t.out_perm, device),
        out_pos=_opt(t.out_pos, device),
        out_src=_opt(t.out_src, device),
        in_len=int(t.in_len),
        out_len=int(t.out_len),
    )


def sparse_a_from_numpy(sa, device) -> SparseA:
    return SparseA(
        a=ell_table_from_numpy(sa.a, device),
        at=ell_table_from_numpy(sa.at, device),
        con_num=int(sa.con_num),
        vec_len=int(sa.vec_len),
        a_idx_compact=None
        if sa.a_idx_compact is None
        else tuple(_tensor(i, device) for i in sa.a_idx_compact),
    )


def maps_from_numpy(maps: Dict[str, Any], device) -> Dict[str, Any]:
    """The ``device_maps`` dict; its static wrappers become plain ints/bools."""

    def conv(v):
        if hasattr(v, "value"):  # cuadmm_tpu.ops.svec.Static
            return v.value
        return _tensor(v, device)

    out = {k: conv(v) for k, v in maps.items() if k != "buckets"}
    out["buckets"] = [{k: conv(v) for k, v in bm.items()} for bm in maps["buckets"]]
    return out


def normal_solver_from_numpy(neq, device) -> NormalEqSolver:
    """A precond, packed or banded NormalEqSolver; factors become f32, the
    port's factor dtype on every device.

    precond: the JAX package keeps the padded f32 inverse factor only on an
    accelerator; from a CPU build (f64 factor ``chol_l``) the port's inverse
    factor is formed the port's way. packed and banded: the (T+1, B, B)
    tiles one to one, the layout tuples, and the band's permutations."""
    common = dict(
        mode=neq.mode,
        sparse_a=sparse_a_from_numpy(neq.sparse_a, device),
        applies=int(neq.applies),
        eps_used=float(neq.eps_used),
    )
    f32 = lambda x: _tensor(x, device).to(torch.float32)
    if neq.mode == "precond":
        inv_l = f32(neq.inv_l) if neq.inv_l is not None else pad_factor(_tri_inv(f32(neq.chol_l)))
        return NormalEqSolver(inv_l=inv_l, **common)
    if neq.mode == "packed":
        return NormalEqSolver(
            packed_tiles=f32(neq.packed_tiles), packed_layout=tuple(int(v) for v in neq.packed_layout),
            **common,
        )
    if neq.mode == "banded":
        return NormalEqSolver(
            band_tiles=f32(neq.band_tiles), band_layout=tuple(int(v) for v in neq.band_layout),
            band_perm=_opt(neq.band_perm, device), band_inv_perm=_opt(neq.band_inv_perm, device),
            **common,
        )
    raise ValueError(f"only precond, packed and banded solvers carry over, got mode={neq.mode!r}")


def state_from_numpy(state, device) -> SolverState:
    return SolverState(
        **{
            name: _tensor(getattr(state, name), device)
            for name in SolverState.__dataclass_fields__
        }
    )


def params_from_numpy(params, device) -> SolveParams:
    scalars = ("b", "C", "normA", "bscale", "Cscale", "objscale", "norm_borg", "norm_Corg")
    return SolveParams(
        sparse_a=sparse_a_from_numpy(params.sparse_a, device),
        maps=maps_from_numpy(params.maps, device),
        neq=normal_solver_from_numpy(params.neq, device),
        **{name: _tensor(getattr(params, name), device) for name in scalars},
    )
