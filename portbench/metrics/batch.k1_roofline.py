"""batch.k1_roofline: K1's share, in %, of the least time the batch's K1
work in the traced solve could take, whatever the launch layout.

The least work is one pass over the f32 factor's lower triangle a batch
sweep, serving all B = ``facts["instances"]`` right-hand sides: bytes
n_pad (n_pad + 1) / 2 x 4 of the triangle and 2 B n_pad x 4 of R in and Y
out at the card's HBM rate, flops 4 B n_pad (n_pad + 1) / 2 at its f32
rate (roofline.peaks), the larger of the two. The traced solve ran
launches x rhs / B batch sweeps: the K1 launches in the trace times the
right-hand sides a launch served (``batch.k1_rhs_per_launch``, the
program's ``k1_rhs`` counter over ``k1``), over B. Their device time is
that of K1's kernels, fused_spd_apply_kernel (any instance) and
sum_partials_kernel. None where an input is missing: no n_pad or
instances in the facts, no counter, no launch, no peaks for the card.
"""

from __future__ import annotations

from typing import Optional

from portbench import batch_trace
from portbench.roofline import peaks

APPLY = "fused_spd_apply_kernel"
KERNELS = (APPLY, "sum_partials_kernel")


def sweep_bound_s(n_pad: int, b: int, kind: str) -> Optional[float]:
    """The least time of one batch sweep's K1 work on the card ``kind``."""
    pk = peaks(kind)
    if pk is None:
        return None
    tri = n_pad * (n_pad + 1) // 2
    return max((4 * tri + 8 * b * n_pad) / pk["hbm_bytes_per_s"], 4 * b * tri / pk["f32_flops"])


def share(n_pad, b, launches: int, rhs, seconds: float, kind: str) -> Optional[float]:
    if not n_pad or not b or not rhs or not launches or seconds <= 0:
        return None
    bound = sweep_bound_s(int(n_pad), int(b), kind)
    return None if bound is None else 100.0 * (launches * rhs / b) * bound / seconds


def read(ctx):
    bt = batch_trace.get(ctx)
    rhs = None if bt is None else bt.k1_rhs_per_launch
    return share(ctx.facts.get("n_pad"), ctx.facts.get("instances"), ctx.trace.count(APPLY), rhs,
                 ctx.trace.device_s(KERNELS), ctx.kind)
