"""Rank meshes over torch.distributed: the port of cuadmm_tpu/parallel/mesh.py.

The JAX package runs several devices as one SPMD program: sharding
annotations on the bucket tensors, and XLA inserts the collectives. The
port runs one process per rank, in lockstep, with explicit collectives. A
``Mesh`` is a process group with one device per rank.

Only two collectives are used, ``all_reduce(SUM)`` and ``broadcast``: they
are the ones gloo supports on CUDA tensors, and gloo is how several ranks
share one card (NCCL refuses two ranks on one GPU). Every gather is a
masked all_reduce, as the JAX package's tri_shard.py assembles its gathers
from psums: a rank writes its part into a zero buffer and all ranks sum
it. A sum of one part and zeros is exact, so every rank gets the same bits.

The solver state stays whole on every rank. The JAX package's
``shard_pool`` and ``replicated`` (cuadmm_tpu/parallel/mesh.py:67-82)
place the flat X/S pool over the devices and let XLA spread its
elementwise updates; the port has no counterpart: those updates cost
O(vec_len), a share of an iteration that splitting would trade for a
collective per update. It shards the work that costs: the projection's
buckets (``shard_blocks``; a single big block's rows under the polynomial
filter, ops/polyfilter.py) and the ``sharded`` normal solver's factor
(parallel/tri_shard.py). Every rank's other work (the normal solve's
refinement, the sparse products, the vector algebra) runs on identical
inputs with deterministic kernels, so the ranks' iterates stay bitwise
equal.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.device import resolve_device

BLOCK_AXIS = "blocks"
# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``size`` ranks of a process group, this process's
    ``rank`` and its ``device``. ``group`` None is the default group."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    axis: str = BLOCK_AXIS

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        trace.COUNTS["all_reduce"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of rank ``src`` (a rank of this mesh) on every rank, in place."""
        trace.COUNTS["broadcast"] += 1
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        dist.broadcast(t, src=src, group=self.group)
        return t


def make_mesh(
    n_devices: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    group=None,
) -> Mesh:
    """This rank's Mesh over the process group ``group`` (None: the default).

    Joins the process group that torchrun or ``parallel.launch.run_ranks``
    started: when none is initialized, it is created from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) with
    ``backend`` (default "nccl" on CUDA, "gloo" on the CPU) and a timeout
    of DEFAULT_TIMEOUT_S. ``n_devices``, when given, must be the group's size.

    ``device`` defaults to the card: rank r takes cuda:(r % device_count),
    and a missing card raises (``device.resolve_device``, which also turns
    TF32 off). ``device="cpu"`` runs the rank on the CPU (gloo only).
    Several ranks on one card need gloo: NCCL refuses them.
    """
    dev = resolve_device("cuda" if device is None else device)
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            raise RuntimeError(
                "make_mesh needs a process group: start the ranks with torchrun or "
                "parallel.launch.run_ranks, or call torch.distributed.init_process_group first"
            )
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
        )
    have = dist.get_backend(group)
    if backend is not None and backend != have:
        raise ValueError(f"make_mesh: backend {backend!r} asked for, the process group runs {have!r}")
    if have == "nccl" and dev.type != "cuda":
        raise ValueError("make_mesh: the nccl backend needs a CUDA device")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the process group has {size} ranks")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(size=size, rank=rank, device=dev, group=group)


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The device a solver on ``mesh`` runs on: the mesh's. A ``device``
    that names another one raises; None, or the mesh's device kind without
    an index, agrees."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh (parallel.mesh.make_mesh), got {type(mesh).__name__}")
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or (d.index is not None and d.index != mesh.device.index):
            raise ValueError(f"device {str(d)!r} disagrees with the mesh's device {str(mesh.device)!r}")
    return mesh.device


def shard_bounds(count: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's contiguous share [lo, hi) of ``count`` items, as XLA
    shards an uneven axis: ceil(count / size) a rank, the last ranks
    taking what remains (possibly nothing)."""
    per = -(-count // mesh.size)
    lo = min(mesh.rank * per, count)
    return lo, min(lo + per, count)


def shard_axis(shape, mesh: Optional[Mesh], inner_if_few: bool = False) -> Optional[int]:
    """The axis of a (count, n, n) bucket that ``shard_blocks`` splits, by
    the JAX package's rules (cuadmm_tpu/parallel/mesh.py:39-64): the batch
    axis when count >= size; the row axis when ``inner_if_few`` and
    n >= 2 size; None (replicated) otherwise, and always at size <= 1."""
    if mesh is None or mesh.size <= 1:
        return None
    if shape[0] >= mesh.size:
        return 0
    if inner_if_few and shape[1] >= 2 * mesh.size:
        return 1
    return None


def shard_blocks(
    x: torch.Tensor, mesh: Optional[Mesh]
) -> Tuple[torch.Tensor, slice, Callable[[torch.Tensor], torch.Tensor]]:
    """This rank's share of a (count, n, n) bucket's blocks, that share as
    a slice of the batch axis, and a ``gather``.

    The bucket is split by blocks when ``shard_axis`` says so (count >=
    size), into ``shard_bounds``' shares; otherwise the share is all of
    ``x``. ``gather(part)`` takes this rank's result for its share (same
    shape) and returns the whole bucket's on every rank, by one masked
    all_reduce; for a bucket that is not split it returns ``part`` as it
    is. (The row split of a single big block is the polynomial filter's
    own: ops/polyfilter.py.)
    """
    if shard_axis(x.shape, mesh) != 0:
        return x, slice(None), lambda part: part
    lo, hi = shard_bounds(x.shape[0], mesh)

    def gather(part: torch.Tensor) -> torch.Tensor:
        full = part.new_zeros(x.shape[:1] + part.shape[1:])
        full[lo:hi] = part
        return mesh.all_reduce(full)

    return x[lo:hi], slice(lo, hi), gather
