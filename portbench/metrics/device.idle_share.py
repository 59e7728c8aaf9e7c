"""device.idle_share: the share of the traced solve's wall time in which no
operation ran on the device, in %: 100 (1 - busy / window), the busy time
the union of the device operations' intervals in the trace."""


def read(ctx):
    tr = ctx.trace
    if not tr.device_ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
