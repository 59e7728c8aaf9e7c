"""Iteration rates of one checkout of the port, to compare two checkouts on
one card.

    python3 cuadmm_tpu_torch/rate_ab.py ROOT [LABEL] [--banded]

Imports ``cuadmm_tpu_torch`` from the checkout at ROOT, so this script can
time an older checkout too, and runs plain ADMM (f64, switch_admm=0) on
chip_smoke.py's stand-in (max-cut on the banded graph n=1560, projection
"auto", which gives its one bucket to K4, and "poly", which runs no K4:
100 warm and 500 timed iterations) and on its 20x60 grid problem
(projections "jacobi", "poly", "eigh" and "auto": 100 warm and 200 timed
iterations each) and on its 20x120 large grid (projection "auto"; the
normal solver's "auto" takes the band there: 100 warm and 200 timed
iterations, in f64 and in f32 state), and the 20x60 grid through
normal_solver "banded" (projection "auto"). ``--banded`` runs only the
three banded runs (K3's path). Each banded row names the layout and the
calibrated sweeps a solve (``applies``). Each run is followed by 50 iterations under
torch.profiler for the device time per iteration. It also times the host
side of ``jacobi_eigh`` alone at the stand-in's bucket shape (1556, 8, 8):
microseconds to queue one call, and the device time per call. The kernels
are built on the first warm iteration. Prints the card line, then one JSON
line.

To compare checkouts A and B, run A, B, B, A, each in its own process, in
one call on the card: machine-to-machine spread then cancels out, and a
difference that follows the checkout in both pairs is the code's.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

WARM = 100
PROFILE_ITERS = 50


def standin(maxcut_chordal):
    n = 1560
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    return maxcut_chordal(W + W.T)[0]


def grid(maxcut_chordal, rows: int = 20, cols: int = 60):
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    return maxcut_chordal((W + W.T).tocsr())[0]


def device_ms_per_it(solver) -> float:
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        solver.solve(max_iter=PROFILE_ITERS, stop_tol=0.0)
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return dev_us / 1e3 / PROFILE_ITERS


def k4_host(jacobi, calls: int = 200) -> dict:
    """Host microseconds to queue one jacobi_eigh call (fewer calls than
    the launch queue holds, so none waits for the device) and device
    microseconds per call, at the stand-in's bucket shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = torch.randn((1556, 8, 8), dtype=torch.float64, device="cuda", generator=gen)
    mats = (m + m.transpose(1, 2)) / 2
    jacobi.jacobi_eigh(mats)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        jacobi.jacobi_eigh(mats)
    queued = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    return dict(queue_us_per_call=queued / calls * 1e6, device_us_per_call=start.elapsed_time(stop) / calls * 1e3)


def rate(pkg, prob, projection: str, iters: int, **config) -> dict:
    cfg = pkg.SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0, projection=projection,
                           **config)
    solver = pkg.SDPSolver(prob, cfg, device="cuda")
    neq = solver.params.neq
    if neq.mode == "banded":  # an older ROOT's solver keeps the layout as band_layout; K3's segments form has none
        lay = getattr(neq.factor, "layout", None) if hasattr(neq, "factor") else neq.band_layout
        band = dict(band_layout=None if lay is None else list(lay), applies=neq.applies)
    else:
        band = {}
    solver.solve(max_iter=WARM, stop_tol=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver.solve(max_iter=iters, stop_tol=0.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if res.iterations != iters or not np.isfinite(res.errRp):
        raise RuntimeError(f"{projection}: {res.iterations} of {iters} iterations, errRp {res.errRp}")
    ms = elapsed * 1e3 / iters
    dev = device_ms_per_it(solver)
    return dict(it_per_s=iters / elapsed, ms_per_it=ms, device_ms_per_it=dev, device_idle_ms_per_it=ms - dev, **band)


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve()
    label = args[1] if len(args) > 1 else root.name
    banded_only = "--banded" in sys.argv
    if not torch.cuda.is_available():
        raise SystemExit("rate_ab: needs a CUDA device")
    sys.path[0] = str(root)  # in place of this script's directory
    import cuadmm_tpu_torch as pkg
    from cuadmm_tpu_torch.device import card_line
    from cuadmm_tpu_torch.models.chordal import maxcut_chordal
    from cuadmm_tpu_torch.ops import jacobi

    print(card_line())
    out = dict(label=label, root=str(root))
    if not banded_only:
        prob = standin(maxcut_chordal)
        for proj in ("auto", "poly"):
            out[f"stand-in {proj}"] = rate(pkg, prob, proj, 500)
        out["k4 host at (1556, 8, 8)"] = k4_host(jacobi)
    prob = grid(maxcut_chordal)
    for proj in () if banded_only else ("jacobi", "poly", "eigh", "auto"):
        out[f"grid {proj}"] = rate(pkg, prob, proj, 200)
    out["grid banded"] = rate(pkg, prob, "auto", 200, normal_solver="banded")
    prob = grid(maxcut_chordal, 20, 120)
    out["large grid auto"] = rate(pkg, prob, "auto", 200)
    out["large grid auto f32"] = rate(pkg, prob, "auto", 200, dtype="float32")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
