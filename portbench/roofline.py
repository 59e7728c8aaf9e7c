"""Peaks of the cards the benchmark runs on, and the work of each kernel
the per-layer rooflines count.

The peaks are the data sheet's dense rates at the card's full power limit
(NVIDIA H100 Tensor Core GPU data sheet): the run prints the card's power
limit beside them. A kernel's bound counts the bytes its inputs need,
each read once, and its outputs, each written once, whatever the kernel
reads again.
"""

from __future__ import annotations

from typing import Optional

# torch.cuda.get_device_name() -> peaks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12, f64_flops=34e12, f32_flops=67e12),
    "NVIDIA H100 PCIe": dict(hbm_bytes_per_s=2.0e12, f64_flops=26e12, f32_flops=51e12),
}


def peaks(kind: str) -> Optional[dict]:
    return PEAKS.get(kind)


def k1_launch_bytes(n_pad: int) -> int:
    """K1 (the precond normal solve's apply of the f32 inverse factor M,
    y = M^T (M r)) once for one right-hand side: the lower triangle of the
    n_pad x n_pad f32 factor read once, r read once and y written once."""
    return n_pad * (n_pad + 1) // 2 * 4 + 2 * n_pad * 4


def k1_bound_s(n_pad: int, kind: str) -> Optional[float]:
    """The least time one K1 launch can take on the card ``kind``: its
    bytes at the card's memory bandwidth (its flops, 2 n_pad^2, are far
    below the f32 peak's share)."""
    pk = peaks(kind)
    return None if pk is None else k1_launch_bytes(n_pad) / pk["hbm_bytes_per_s"]
