"""normal_solve.k1_roofline: K1's share of its bound, in %: the least time
its launches in the traced solve could take (roofline.k1_bound_s at the
factor's n_pad, one right-hand side a launch) over the device time of its
kernels, fused_spd_apply_kernel and sum_partials_kernel."""

from portbench.roofline import k1_bound_s

APPLY = "fused_spd_apply_kernel"
KERNELS = (APPLY, "sum_partials_kernel")


def read(ctx):
    n_pad = ctx.facts.get("n_pad")
    launches = ctx.trace.count(APPLY)
    bound = k1_bound_s(n_pad, ctx.kind) if n_pad else None
    seconds = ctx.trace.device_s(KERNELS)
    if bound is None or not launches or seconds <= 0:
        return None
    return 100.0 * launches * bound / seconds
