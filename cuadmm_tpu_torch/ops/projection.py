"""Projection onto the product of PSD cones, in pool coordinates.

Port of cuadmm_tpu/ops/projection.py (psd_project_pool with the "eigh"
method, reconstruct_clamped). Each size bucket is one batched
``torch.linalg.eigh`` (cuSOLVER on the card) and one batched
V diag(max(w, 0)) V^T product; 1x1 buckets are clamped. The "poly" and
"jacobi" methods are not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def reconstruct_clamped(
    w: torch.Tensor, v: torch.Tensor, eig_rank: Optional[int] = None
) -> torch.Tensor:
    """P = V diag(max(w, 0)) V^T, batched. With ``eig_rank`` r only the r
    largest eigenvalues survive (eigh returns them ascending)."""
    wc = torch.clamp(w, min=0.0)
    if eig_rank is not None and eig_rank < w.shape[-1]:
        wc[..., : w.shape[-1] - eig_rank] = 0.0
    return (v * wc.unsqueeze(-2)) @ v.transpose(-1, -2)


def psd_project_pool(
    P: torch.Tensor,
    maps: Dict[str, Any],
    eig_rank: Optional[int] = None,
    method: str = "eigh",
) -> torch.Tensor:
    """Project a pool-coordinate vector onto the product cone.

    Each bucket's (count, n, n) tensor is a reshape of a pool segment. The
    projected bucket is multiplied by its 0/1 padding mask so eigh round-off
    never leaks into padded positions. Free entries pass through unchanged.

    ``torch.linalg.eigh`` checks its solver's status on the host, so on
    CUDA each call waits for the device.
    """
    if method != "eigh":
        raise NotImplementedError(
            f"projection={method!r} is not ported yet (ROADMAP.md queue 1: "
            "'Projection: poly and jacobi methods'); the port has 'eigh'"
        )
    parts = []
    for bm in maps["buckets"]:
        count, n, base = bm["count"], bm["n"], bm["base"]
        seg = P[base : base + count * n * n]
        if n == 1:
            parts.append(torch.clamp(seg, min=0.0))
            continue
        bt = seg.reshape(count, n, n)
        packed = bm["packed"]
        if packed:
            # Norm-equalize each real block of a packed super-matrix
            # (projection is positively homogeneous), so small-norm packmates
            # keep relative accuracy.
            gid = bm["diag_group"]  # (count, n), padding -> n_groups
            rowsq = torch.sum(bt * bt, dim=-1).reshape(-1)
            sums = bt.new_zeros(bm["n_groups"] + 1).index_add_(0, gid.reshape(-1), rowsq)
            norms = torch.sqrt(sums)
            ok = norms > torch.finfo(bt.dtype).tiny * 16
            s_blk = torch.where(ok, 1.0 / torch.where(ok, norms, 1.0), 1.0)
            bt = bt * s_blk[gid][:, :, None]
        # eigh raises on non-finite input where XLA returns NaN. Project a
        # zeroed copy and put NaN back on those blocks, so a diverging
        # iterate reaches the driver's divergence guard as it does in JAX.
        finite = torch.isfinite(bt)
        w, v = torch.linalg.eigh(torch.where(finite, bt, 0.0))
        proj = reconstruct_clamped(w, v, eig_rank)
        proj = torch.where(finite.all(dim=-1).all(dim=-1)[:, None, None], proj, torch.nan)
        if packed:
            proj = proj * torch.where(ok, norms, 1.0)[gid][:, :, None]
        parts.append((proj * bm["pad_mask"]).reshape(-1))
    if maps["free_pos"].shape[0]:
        fb = maps["free_base"]
        parts.append(P[fb : fb + maps["free_pos"].shape[0]])
    return parts[0] if len(parts) == 1 else torch.cat(parts)
