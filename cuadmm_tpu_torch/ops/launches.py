"""The kernel wrappers' launch counts, one entry a kernel.

Each wrapper adds one to its entry where it launches its kernel on CUDA
tensors, and nowhere else (its CPU fallback counts nothing):

  k1      fused_spd_apply (ops/precond_apply.py)
  k2      packed_solve (ops/tri_stream.py; one call queues both sweeps)
  k3      band_solve (ops/tri_stream.py; likewise)
  k4      jacobi_eigh (ops/jacobi.py), every dtype
  k4_f32  jacobi_eigh's float32 launches among k4's

A CUDA graph's kernels launch on replay, where no wrapper runs: the chunk
runner (solver/step.py) adds a recording's counts on each replay.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = dict(k1=0, k2=0, k3=0, k4=0, k4_f32=0)


def add(delta: Dict[str, int], sign: int = 1) -> None:
    """Add ``sign * delta`` to the counts."""
    for k, v in delta.items():
        LAUNCHES[k] += sign * v


def reset() -> None:
    """Set every count to 0."""
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))
