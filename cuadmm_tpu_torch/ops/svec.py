"""svec <-> pool and svec <-> block conversion as gathers over the
BlockStructure tables.

Port of cuadmm_tpu/ops/svec.py (device_maps, svec_to_blocks,
blocks_to_svec, pool_from_svec, svec_from_pool). The pool layout is the
hot loop's representation: the flat concatenation of every bucket's
(count, n, n) dense symmetric tensor plus the free entries, off-diagonals
at x_svec/sqrt(2) in both mirrored slots. These converters run only at
solve boundaries; the block form is ``projection.psd_project``'s. Layout
sizes that jit treated as static are plain Python ints here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch


def _idx(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def device_maps(structure, dtype: torch.dtype, device) -> Dict[str, Any]:
    """Move a BlockStructure's tables onto ``device`` (indices as int64)."""
    val = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    buckets = []
    for bi, bk in enumerate(structure.buckets):
        buckets.append(
            dict(
                gather_idx=_idx(bk.gather_idx, device),
                gather_scale=val(bk.gather_scale),
                pool_pos=_idx(bk.pool_pos, device),
                out_scale=val(bk.out_scale),
                base=int(structure.bucket_base[bi]),
                n=int(bk.n),
                count=int(bk.count),
                packed=bool(bk.packed),
                n_groups=int(bk.n_groups),
                diag_group=_idx(
                    np.where(bk.diag_blkid >= 0, bk.diag_blkid, bk.n_groups), device
                ),
                pad_mask=val(bk.gather_scale != 0.0),
                pool_pos_global=_idx(bk.pool_pos + structure.bucket_base[bi], device),
            )
        )
    return dict(
        buckets=buckets,
        free_pos=_idx(structure.free_pos, device),
        inv_perm=_idx(structure.inv_perm, device),
        free_base=int(structure.free_base),
        pool_len=int(structure.pool_len),
        vec_len=int(structure.vec_len),
    )


def svec_to_blocks(X: torch.Tensor, maps: Dict[str, Any]) -> List[torch.Tensor]:
    """svec ``X`` as per-bucket (count, n, n) symmetric tensors:
    off-diagonals scaled by 1/sqrt(2), padding zero (the gather tables
    point it at a trailing zero)."""
    X_ext = torch.cat([X, X.new_zeros(1)])
    return [X_ext[bm["gather_idx"]] * bm["gather_scale"] for bm in maps["buckets"]]


def blocks_to_svec(blocks: Sequence[torch.Tensor], X: torch.Tensor, maps: Dict[str, Any]) -> torch.Tensor:
    """Per-bucket tensors back to svec, off-diagonals scaled by sqrt(2); the
    free entries are taken from ``X``."""
    parts = [bt.reshape(-1)[bm["pool_pos"]] * bm["out_scale"] for bt, bm in zip(blocks, maps["buckets"])]
    if maps["free_pos"].shape[0]:
        parts.append(X[maps["free_pos"]])
    all_vals = parts[0] if len(parts) == 1 else torch.cat(parts)
    return all_vals[maps["inv_perm"]]


def pool_from_svec(X: torch.Tensor, maps: Dict[str, Any]) -> torch.Tensor:
    """svec -> pool coordinates (one boundary-time gather)."""
    X_ext = torch.cat([X, X.new_zeros(1)])
    parts = [
        (X_ext[bm["gather_idx"]] * bm["gather_scale"]).reshape(-1)
        for bm in maps["buckets"]
    ]
    if maps["free_pos"].shape[0]:
        parts.append(X[maps["free_pos"]])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def svec_from_pool(P: torch.Tensor, maps: Dict[str, Any]) -> torch.Tensor:
    """pool -> svec coordinates (one vec_len-sized gather)."""
    parts = [P[bm["pool_pos_global"]] * bm["out_scale"] for bm in maps["buckets"]]
    if maps["free_pos"].shape[0]:
        fb = maps["free_base"]
        parts.append(P[fb : fb + maps["free_pos"].shape[0]])
    all_vals = parts[0] if len(parts) == 1 else torch.cat(parts)
    return all_vals[maps["inv_perm"]]
