"""Carry the JAX package's solver objects over to the port.

Each function takes one of ``cuadmm_tpu``'s objects (SolverState,
SolveParams, SparseA/EllTable, the ``device_maps`` dict, a NormalEqSolver of any
mode but host) whose array fields are numpy arrays or anything
``np.asarray`` reads, and returns the port's counterpart on ``device``.
So one step of each package can start from identical state. Dtypes carry
over as they are: an f32 state, the f32 and f64 copies of A's tables and
a normal solver built for an f32 state (whose refinement reads the f64
copy) arrive as the port's f32 driver holds them. This module never
imports jax: it only reads attributes and converts arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from cuadmm_tpu_torch.ops import tri_stream
from cuadmm_tpu_torch.ops.chol import (
    BandFactor, CGSolver, CholFactor, InverseFactor, NormalEqSolver, PackedFactor, ShardedFactor, SplitFactor,
    _tri_inv, chain_tiles,
)
from cuadmm_tpu_torch.ops.limits import card_limits
from cuadmm_tpu_torch.ops.precond_apply import pad_factor
from cuadmm_tpu_torch.ops.sparse import EllTable, SparseA
from cuadmm_tpu_torch.parallel.mesh import Mesh
from cuadmm_tpu_torch.parallel.tri_shard import shard_factor
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


def normal_solver_from_numpy(neq, device, mesh: Mesh = None) -> NormalEqSolver:
    """A precond, dense, split, packed, banded, sharded or cg
    NormalEqSolver. f32 factors stay f32 (the port's factor dtype), f64 ones
    f64. sharded needs the port's ``mesh``: the JAX package's factor grid
    is one global (nb, nb, B, B) array, its block columns sharded over the
    JAX mesh (``np.asarray`` gathers it), and each rank takes its column
    slab (``tri_shard.shard_factor``). The port's mesh size need not be the
    JAX mesh's: it must divide nb. The grid's dtype carries over (f64 from
    a CPU build, f32 from an accelerator's).

    Each mode's factor is the port's class (ops/chol.py). The JAX package
    keeps precond's padded f32 inverse factor only on an accelerator; from
    a CPU build (f64 factor ``chol_l``) the port forms it the port's way.
    Either way, and for split's prefix, it goes through ``pad_factor``, so
    it is exactly zero above the diagonal, as K1 requires. split's prefix
    from a CPU build is a ``CholFactor``. packed and banded: the tiles one
    to one; a band also gets K3's form and derived tiles
    (``chol.chain_tiles``) for the card it lands on (``card_limits``)."""
    f32 = lambda x: _tensor(x, device).to(torch.float32)
    table = lambda t: None if t is None else ell_table_from_numpy(t, device)
    inverse = lambda: InverseFactor(pad_factor(_tri_inv(f32(neq.chol_l)) if neq.inv_l is None else f32(neq.inv_l)))
    if neq.mode == "precond":
        factor = inverse()
    elif neq.mode == "dense":
        factor = CholFactor(_tensor(neq.chol_l, device))
    elif neq.mode == "split":
        prefix = None if neq.chol_l is None else CholFactor(_tensor(neq.chol_l, device))
        factor = SplitFactor(prefix if neq.inv_l is None else inverse(), int(neq.split_p),
                             _tensor(neq.tail_inv_diag, device).to(torch.float64),
                             _opt(neq.split_perm, device), _opt(neq.split_inv_perm, device))
    elif neq.mode == "packed":
        factor = PackedFactor(f32(neq.packed_tiles), tri_stream.PackedLayout(*(int(v) for v in neq.packed_layout)))
    elif neq.mode == "banded":
        lay = tri_stream.BandLayout(*(int(v) for v in neq.band_layout))
        tiles = f32(neq.band_tiles)
        max_bytes = card_limits(tiles.device).band_max_bytes if tiles.device.type == "cuda" else None
        factor = BandFactor(tiles, lay, *chain_tiles(tiles, lay, max_bytes), _opt(neq.band_perm, device),
                            _opt(neq.band_inv_perm, device))
    elif neq.mode == "sharded":
        if mesh is None:
            raise ValueError("a sharded solver carries over onto a rank mesh: pass mesh=")
        factor = ShardedFactor(shard_factor(neq.shard_grid, mesh), mesh)
    elif neq.mode == "cg":
        factor = CGSolver(_tensor(neq.inv_diag, device), _opt(neq.bj_inv, device), table(neq.aat_tbl),
                          table(neq.fsai_g), table(neq.fsai_gt), float(neq.cg_tol), int(neq.cg_max_iter))
    else:
        raise ValueError(f"a {neq.mode!r} solver does not carry over (every mode but host does)")
    return NormalEqSolver(neq.mode, sparse_a_from_numpy(neq.sparse_a, device), factor, int(neq.applies),
                          float(neq.eps_used))


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


def rp_hp_from_numpy(solver, device) -> tuple:
    """The f64 tables of the port's ``rp_hp`` step (solver/step.py) from a
    JAX SDPSolver: its f64 copy of A's tables and its unrounded scaled b
    and row norms, as its driver builds them (cuadmm_tpu/solver/driver.py:
    440-454)."""
    f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device)
    return sparse_a_from_numpy(solver._sa_hp, device), f64(solver._b_scaled), f64(solver.scaling.normA)
