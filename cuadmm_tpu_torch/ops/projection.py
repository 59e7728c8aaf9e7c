"""Projection onto the product of PSD cones, in pool or svec coordinates.

Port of cuadmm_tpu/ops/projection.py (psd_project_pool, psd_project,
reconstruct_clamped, xla_eigh as ``eigh``). The solver projects in pool
coordinates (``psd_project_pool``); ``psd_project`` is the same
projection of an svec vector through the per-bucket blocks of
ops/svec.py, without the pool's norm equalization and padding mask, as in
the JAX package. Each size bucket is projected by one of three methods,
per bucket when ``method`` is a dict:

- "eigh": batched ``torch.linalg.eigh`` (cuSOLVER on the card), then one
  batched V diag(max(w, 0)) V^T product. eigh checks its solver's status
  on the host, so on CUDA each call waits for the device, and a CUDA graph
  cannot hold it: the chunk runner (solver/step.py) passes ``eigh=``, which
  runs each eigh call between two graphs.
- "jacobi": the batched Jacobi eigh of ops/jacobi.py (the CUDA kernel K4 on
  the card; no host wait), then the same product.
- "poly": the matmul-only polynomial filter of ops/polyfilter.py.

1x1 buckets are clamped. ``eigh_by_bucket`` maps a bucket index to an
``eigh(x) -> (w, v)`` that replaces that bucket's decomposition; under
"poly" it makes that bucket decompose and reconstruct. No solver path
passes it, as in the JAX package.

Over a rank mesh (``mesh=``, parallel/mesh.py) a bucket with at least one
block per rank is split along its batch axis: each rank projects its
contiguous share with the bucket's method and one masked all_reduce
rebuilds the bucket on every rank. Under "poly" a bucket with fewer blocks
than ranks (QUASAR's single 2004 block) is split by rows inside the
filter. Every other bucket, the 1x1 buckets and the free entries are
projected whole on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from cuadmm_tpu_torch.ops.dispatch import bucket_method
from cuadmm_tpu_torch.ops.jacobi import jacobi_eigh
from cuadmm_tpu_torch.ops.polyfilter import psd_project_poly
from cuadmm_tpu_torch.ops.svec import blocks_to_svec, svec_to_blocks
from cuadmm_tpu_torch.parallel.mesh import Mesh, shard_axis, shard_blocks


def reconstruct_clamped(
    w: torch.Tensor, v: torch.Tensor, eig_rank: Optional[int] = None
) -> torch.Tensor:
    """P = V diag(max(w, 0)) V^T, batched. With ``eig_rank`` r only the r
    largest eigenvalues survive (eigh returns them ascending)."""
    wc = torch.clamp(w, min=0.0)
    if eig_rank is not None and eig_rank < w.shape[-1]:
        wc[..., : w.shape[-1] - eig_rank] = 0.0
    return (v * wc.unsqueeze(-2)) @ v.transpose(-1, -2)


def _finite_eigh(mats: torch.Tensor, eigh_fn: Callable) -> tuple:
    """``eigh_fn`` on ``mats`` with non-finite entries zeroed (torch's eigh
    raises on them where XLA returns NaN): (w, v, which blocks were
    finite)."""
    finite = torch.isfinite(mats)
    w, v = eigh_fn(torch.where(finite, mats, 0.0))
    return w, v, finite.all(dim=-1).all(dim=-1)


def eigh(mats: torch.Tensor) -> tuple:
    """Batched symmetric eigendecomposition (w, v) by ``torch.linalg.eigh``
    (cuSOLVER on the card), the JAX package's ``xla_eigh``: a block with a
    non-finite entry gets NaN in w and v, as XLA returns."""
    w, v, ok = _finite_eigh(mats, torch.linalg.eigh)
    return torch.where(ok[..., None], w, torch.nan), torch.where(ok[..., None, None], v, torch.nan)


def _eigh_project(bt: torch.Tensor, eig_rank: Optional[int], eigh: Callable) -> torch.Tensor:
    # Project a zeroed copy of a non-finite block and put NaN back on it,
    # so a diverging iterate reaches the driver's divergence guard as it
    # does in JAX.
    w, v, ok = _finite_eigh(bt, eigh)
    return torch.where(ok[:, None, None], reconstruct_clamped(w, v, eig_rank), torch.nan)


def _project_bucket(bt: torch.Tensor, meth: str, i: int, eig_rank: Optional[int], eigh: Callable,
                    override: Optional[Callable], row_mesh: Optional[Mesh]) -> torch.Tensor:
    """Bucket ``i``'s (count, n, n) blocks projected by ``meth``, or by the
    decomposition ``override`` (its ``eigh_by_bucket`` entry) where given;
    ``eigh`` computes the "eigh" method's decompositions, ``row_mesh``
    splits "poly"'s rows."""
    if override is not None:
        return reconstruct_clamped(*override(bt), eig_rank)
    if meth == "poly":
        return psd_project_poly(bt, mesh=row_mesh)
    if meth == "jacobi":
        return reconstruct_clamped(*jacobi_eigh(bt), eig_rank)
    if meth == "eigh":
        return _eigh_project(bt, eig_rank, eigh)
    raise ValueError(f"unknown projection method {meth!r} for bucket {i}")


def psd_project(
    Xb: torch.Tensor,
    maps: Dict[str, Any],
    eigh_by_bucket: Optional[Dict[int, Callable]] = None,
    mesh: Optional[Mesh] = None,
    eig_rank: Optional[int] = None,
    method: Union[str, Dict[int, str]] = "eigh",
) -> torch.Tensor:
    """Project an svec vector ``Xb`` onto the product cone: each bucket's
    blocks (``svec_to_blocks``) by its method, 1x1 buckets clamped, the
    free entries passed through (``blocks_to_svec``).

    ``method`` and ``mesh`` as in ``psd_project_pool`` (every rank passes
    the same ``Xb`` and gets the whole result); ``eigh_by_bucket`` as in
    the module docstring."""
    overrides = eigh_by_bucket or {}
    projected = []
    for i, bt in enumerate(svec_to_blocks(Xb, maps)):
        if bt.shape[-1] == 1:
            projected.append(torch.clamp(bt, min=0.0))
            continue
        meth = bucket_method(method, i)
        row_mesh = mesh if shard_axis(bt.shape, mesh, inner_if_few=meth == "poly") == 1 else None
        bt, _, gather = shard_blocks(bt, mesh)
        projected.append(gather(_project_bucket(bt, meth, i, eig_rank, torch.linalg.eigh,
                                                overrides.get(i), row_mesh)))
    return blocks_to_svec(projected, Xb, maps)


def psd_project_pool(
    P: torch.Tensor,
    maps: Dict[str, Any],
    eig_rank: Optional[int] = None,
    method: Union[str, Dict[int, str]] = "eigh",
    mesh: Optional[Mesh] = None,
    eigh: Callable = torch.linalg.eigh,
    eigh_by_bucket: Optional[Dict[int, Callable]] = None,
) -> torch.Tensor:
    """Project a pool-coordinate vector (..., pool_len) onto the product
    cone, each leading index (an instance of a batch) on its own.

    Each bucket's (count, n, n) tensor is a reshape of a pool segment; with
    leading axes the instances' buckets form one (L * count, n, n) batch. The
    projected bucket is multiplied by its 0/1 padding mask so round-off
    never leaks into padded positions. Free entries pass through unchanged.
    ``method`` is one method for every bucket, or a dict from bucket index
    to method (the calibrated dispatch of ops/dispatch.py, ``bucket_method``).
    ``mesh`` splits the buckets over its ranks (module docstring); every
    rank passes the same ``P`` (one instance) and gets the whole result.
    ``eigh(x) -> (w, v)`` computes the "eigh" method's decompositions (the
    chunk runner's segment boundaries); ``eigh_by_bucket`` as in the module
    docstring.
    """
    overrides = eigh_by_bucket or {}
    lead = P.shape[:-1]
    if mesh is not None and mesh.size > 1 and lead:
        raise ValueError("psd_project_pool: a mesh splits one instance's buckets; P must be 1-D")
    parts = []
    for i, bm in enumerate(maps["buckets"]):
        count, n, base = bm["count"], bm["n"], bm["base"]
        seg = P[..., base : base + count * n * n]
        if n == 1:
            parts.append(torch.clamp(seg, min=0.0))
            continue
        meth = bucket_method(method, i)
        bt = seg.reshape(-1, n, n)
        mask = bm["pad_mask"].reshape(count, n, n)
        gid = bm["diag_group"]  # (count, n), padding -> n_groups
        # Over a mesh: this rank's share of the blocks and the gather that
        # rebuilds the bucket (the bucket itself and the identity when it is
        # not split by blocks; "poly" splits a single big block's rows itself).
        row_mesh = mesh if shard_axis(bt.shape, mesh, inner_if_few=meth == "poly") == 1 else None
        bt, share, gather = shard_blocks(bt, mesh)
        mask, gid = mask[share], gid[share]
        packed = bm["packed"]
        if packed:
            # Norm-equalize each real block of a packed super-matrix
            # (projection is positively homogeneous), so small-norm packmates
            # keep relative accuracy.
            n_inst = math.prod(lead)
            if n_inst > 1:  # each instance's groups take their own slots
                step = bm["n_groups"] + 1
                gid = (gid + step * torch.arange(n_inst, device=gid.device)[:, None, None]).reshape(-1, n)
            rowsq = torch.sum(bt * bt, dim=-1).reshape(-1)
            sums = bt.new_zeros(n_inst * (bm["n_groups"] + 1)).index_add_(0, gid.reshape(-1), rowsq)
            norms = torch.sqrt(sums)
            ok = norms > torch.finfo(bt.dtype).tiny * 16
            s_blk = torch.where(ok, 1.0 / torch.where(ok, norms, 1.0), 1.0)
            bt = bt * s_blk[gid][:, :, None]
        proj = _project_bucket(bt, meth, i, eig_rank, eigh, overrides.get(i), row_mesh)
        if packed:
            proj = proj * torch.where(ok, norms, 1.0)[gid][:, :, None]
        proj = gather(proj * mask) if not lead else proj.reshape(lead + (count, n, n)) * mask
        parts.append(proj.reshape(lead + (-1,)))
    if maps["free_pos"].shape[0]:
        fb = maps["free_base"]
        parts.append(P[..., fb : fb + maps["free_pos"].shape[0]])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
