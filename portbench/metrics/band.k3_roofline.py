"""band.k3_roofline: K3's share of its bound, in %: the least time its
sweeps in the traced solve could take over the device time of its
kernels, chain_sweep_kernel (the one-hop form) and tri_sweep_kernel (the
two-hop form), one sweep a launch.

The bound counts the factor's own work, not the tiles K3 streams: the
entries of the RCM band of AA^T's Cholesky factor, n (bw + 1) f32 values
for the problem's n rows at the bandwidth bw that the normal solver's
probe found, each read once a sweep, with the sweep's right-hand side
read once and its solution written once (f32), at the card's HBM rate.
A later block size or tile layout is judged against the same bytes.
None where no K3 kernel ran, or the bandwidth or the card's peaks are
unknown.
"""

from __future__ import annotations

from typing import Optional

from portbench.roofline import peaks

KERNELS = ("chain_sweep_kernel", "tri_sweep_kernel")


def sweep_bytes(n: int, bw: int) -> int:
    """One K3 sweep (forward or backward) over a band of n rows and
    bandwidth bw: the band's entries, r and y, all f32."""
    return 4 * n * (bw + 1) + 2 * 4 * n


def sweep_bound_s(n: int, bw: int, kind: str) -> Optional[float]:
    """The least time one K3 sweep can take on the card ``kind``: its bytes
    at the card's memory bandwidth (its flops, 2 n (bw + 1), are far below
    the f32 peak's share)."""
    pk = peaks(kind)
    return None if pk is None else sweep_bytes(n, bw) / pk["hbm_bytes_per_s"]


def read(ctx):
    solver = getattr(ctx.program, "solver", None)
    bw = (getattr(ctx.program, "init_breakdown", None) or {}).get("neq.band_bw")
    if solver is None or bw is None:
        return None
    launches = sum(ctx.trace.count(k) for k in KERNELS)
    seconds = ctx.trace.device_s(KERNELS)
    bound = sweep_bound_s(int(solver.problem.con_num), int(bw), ctx.kind)
    if bound is None or not launches or seconds <= 0:
        return None
    return 100.0 * launches * bound / seconds
