"""driver.host_syncs_per_it: the host's waits for the device an iteration
of a solve, counted by torch's sync debug mode as chip_smoke.py's
``host_syncs_per_iteration`` counts them: the warnings over a solve of 2k
iterations less those over one of k (each solve's fixed start and end
drop out), after a first k-iteration solve that is not counted; k = 50,
one chunk at the configurations' check_every."""

import warnings

import torch

K = 50


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    counts = []
    for iters in (K, K, 2 * K):
        ctx.sync()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ctx.program.solve(iters, ctx.stop_tol)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return (counts[2] - counts[1]) / K
