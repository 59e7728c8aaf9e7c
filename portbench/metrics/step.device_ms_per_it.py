"""step.device_ms_per_it: device milliseconds an iteration, the sum of every
device operation's time in the traced solve over its iterations."""


def read(ctx):
    tr = ctx.trace
    if not tr.device_ops or not tr.iterations:
        return None
    return 1e3 * tr.device_s() / tr.iterations
