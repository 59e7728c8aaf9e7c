"""projection.device_ms_per_it: device milliseconds an iteration of the
kernels that layers/projection.json puts in the projection (K4, the poly
filter's GEMMs, eigh's kernels)."""


def read(ctx):
    s = ctx.layer_s.get("projection", 0.0)
    if s <= 0 or not ctx.trace.iterations:
        return None
    return 1e3 * s / ctx.trace.iterations
