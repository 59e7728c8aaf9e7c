"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels K1 (csrc/precond_apply.cu) and K4
   (csrc/jacobi_eigh.cu) into build/, one nvcc each, both at once;
3. hold K1 against its plain PyTorch version at n_pad 128, 1024, 17152 and
   32768 (relative error <= 1e-5), with both times from CUDA events;
4. hold K4 against its plain version ``jacobi_eigh_ref`` at n = 2, 3, 4, 5,
   8, 13, 16, 32, 45, 64 with the batch of the grid problem's bucket each
   n falls in (80, 598, 182, 49, 11), in f64 and f32: sorted eigenvalues,
   the projection V diag(w+) V^T and the orthogonality of V, relative to
   the largest |entry|, within 1e-10 (f64) / 5e-5 (f32); K4, the plain
   version and torch.linalg.eigh + reconstruction timed with CUDA events;
5. run the stand-in problem (max-cut, chordally decomposed, banded graph
   n=1560 with off-diagonals 1..4: 17,110 constraints, 1,556 5x5 blocks)
   through SDPSolver in float64 with normal_solver and projection "auto":
   100 warm iterations, 500 timed plain-ADMM iterations, 200 sGS
   iterations, gated on finite and decreasing residuals and on K1 having
   run on every refinement sweep; then 50 more iterations of each mode
   under torch.profiler for the device busy share, the device ops per
   iteration, K1's share and the costliest device ops;
6. run the grid problem (max-cut, chordally decomposed, 4-neighbour 20x60
   grid graph: 32,427 constraints, 920 blocks of sizes 3..45 in pow2
   buckets 4x80, 8x598, 16x182, 32x49, 64x11; precond with n_pad 32,512)
   plain ADMM with each projection "jacobi", "poly", "eigh" and "auto"
   (the committed CUDA table): 100 warm and 200 timed iterations, gated as
   the stand-in and, for "jacobi", on K4 having run on every bucket of
   every iteration; host syncs per iteration of each method; a profile of
   "jacobi" and "eigh"; "auto" again with pack_to=128;
7. solve a certified random SDP to 1e-6 and match its known optimum.

The next-to-last line is the kernel table as JSON, the last line
{"ok": true, "device": {...}}. Everything printed also goes to
chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

import cuadmm_tpu_torch  # noqa: F401  (first: fails alone, without the repo)

import json
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch import SDPSolver, SolverConfig, _build
from cuadmm_tpu_torch.device import card_line
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.ops import jacobi, precond_apply
from cuadmm_tpu_torch.ops.dispatch import bucket_method
from cuadmm_tpu_torch.ops.projection import reconstruct_clamped
from cuadmm_tpu_torch.ops.sparse import aat_matvec

K1_SIZES = (128, 1024, 17152, 32512, 32768)  # 17152: stand-in, 32512: grid
K1_REL_TOL = 1e-5  # f32 sums taken in another order than cuBLAS's
K1_REPS = 20
STANDIN_N_PAD = 17152  # the stand-in's padded factor: the main path's K1 shape
PROFILE_ITERS = 50
PROFILE_TOP = 10  # device ops listed per mode, by self time
# K4's shapes: (n, batch); the batch is that of the grid problem's pow2
# bucket n falls in. The grid's own bucket shapes are GRID_BUCKETS.
K4_SHAPES = ((2, 80), (3, 80), (4, 80), (5, 598), (8, 598), (13, 182), (16, 182),
             (32, 49), (45, 11), (64, 11))
K4_TOL = {torch.float64: 1e-10, torch.float32: 5e-5}  # tests/test_jacobi.py:67-73
K4_REPS = 5
GRID = (20, 60)
GRID_BUCKETS = ((4, 80), (8, 598), (16, 182), (32, 49), (64, 11))
GRID_N_PAD = 32512
GRID_WARM, GRID_ITERS, SYNC_ITERS = 100, 200, 10
REPORT = Path("chiprun_out") / "chip_smoke.json"
report: dict = {}  # everything printed, written to REPORT at the end


def emit(key: str, obj) -> None:
    report[key] = obj
    print(f"{key}: " + json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    out = card_line()
    print(out)
    report["card"] = out
    return torch.cuda.get_device_name(0)


def build_kernels() -> None:
    """One nvcc per source, all started together."""
    t0 = time.perf_counter()
    names = ("precond_apply", "jacobi_eigh")
    with ThreadPoolExecutor(len(names)) as pool:
        paths = list(pool.map(_build.build, names))
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    for path in paths:
        print(f"  {path.name}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("    ptxas:", line.strip())


def _time_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_k1() -> dict:
    """K1 against the plain version on M = inv(L), L well-conditioned lower
    triangular, at each size; times taken in turns (plain, K1, K1, plain)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    at_main_shape = None
    for i, n in enumerate(K1_SIZES):
        gen.manual_seed(i)
        L = torch.eye(n, device=dev) + torch.tril(
            torch.randn(n, n, device=dev, generator=gen), -1
        ) * (0.1 / n**0.5)
        m = torch.linalg.solve_triangular(L, torch.eye(n, device=dev), upper=False).contiguous()
        del L
        r = torch.randn(n, device=dev, generator=gen)
        y = precond_apply.fused_spd_apply(m, r)
        ref = precond_apply.fused_spd_apply_ref(m, r)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
        max_abs = float((y - ref).abs().max())
        check(bool(torch.isfinite(y).all()) and rel <= K1_REL_TOL, f"K1 n_pad={n} rel err {rel:.3e}")
        k1 = lambda: precond_apply.fused_spd_apply(m, r)
        plain = lambda: precond_apply.fused_spd_apply_ref(m, r)
        for _ in range(3):
            k1(), plain()
        p1 = _time_ms(plain, K1_REPS)
        k_1 = _time_ms(k1, K1_REPS)
        k_2 = _time_ms(k1, K1_REPS)
        p2 = _time_ms(plain, K1_REPS)
        k_ms, p_ms = (k_1 + k_2) / 2, (p1 + p2) / 2
        gbs = 4.0 * n * n / (k_ms * 1e-3) / 1e9
        print(
            f"K1 n_pad={n}: rel_err={rel:.3e} max_abs_err={max_abs:.3e} "
            f"k1_ms={k_ms:.4f} plain_ms={p_ms:.4f} k1_GB/s={gbs:.1f}"
        )
        report.setdefault("k1", []).append(dict(n_pad=n, rel_err=rel, k1_ms=k_ms, plain_ms=p_ms))
        if n == STANDIN_N_PAD:
            at_main_shape = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms)
        del m, r, y, ref
        torch.cuda.empty_cache()
    return at_main_shape


def _sym_batch(n: int, batch: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randn((batch, n, n), dtype=dtype, device="cuda", generator=gen)
    return (m + m.transpose(1, 2)) / 2


def _k4_errors(mats, w, v, wr, vr) -> tuple:
    """Errors relative to the largest |entry|: sorted w, projection, and
    orthogonality of v (absolute)."""
    scale = float(mats.abs().max())
    dw = float((w.sort(dim=1).values - wr.sort(dim=1).values).abs().max())
    dp = float((reconstruct_clamped(w, v) - reconstruct_clamped(wr, vr)).abs().max())
    eye = torch.eye(mats.shape[-1], dtype=mats.dtype, device=mats.device)
    orth = float((v.transpose(1, 2) @ v - eye).abs().max())
    return dw / scale, dp / scale, orth, max(dw, dp)


def compare_k4() -> dict:
    """K4 against jacobi_eigh_ref at every K4_SHAPES point, f64 and f32;
    times taken in turns (plain, K4, K4, plain; the first plain run is also
    the reference of the check), and eigh + reconstruction beside them.
    Returns the f64 sums over the grid's bucket shapes for the kernel table."""
    at_grid = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    rows = []
    for dtype in (torch.float64, torch.float32):
        tol = K4_TOL[dtype]
        for n, batch in K4_SHAPES:
            mats = _sym_batch(n, batch, dtype, seed=n)
            k4 = lambda: jacobi.jacobi_eigh(mats)
            plain = lambda: jacobi.jacobi_eigh_ref(mats)
            eigh = lambda: reconstruct_clamped(*torch.linalg.eigh(mats))
            w, v = k4()  # first launch, untimed
            torch.cuda.synchronize()
            ref = []
            p1 = _time_ms(lambda: ref.append(plain()), 1)
            k_1 = _time_ms(k4, K4_REPS)
            k_2 = _time_ms(k4, K4_REPS)
            p2 = _time_ms(plain, 1)
            eigh()
            e_ms = _time_ms(eigh, K4_REPS)
            rel_w, rel_p, orth, max_abs = _k4_errors(mats, w, v, *ref[0])
            ok = bool(torch.isfinite(w).all() and torch.isfinite(v).all())
            check(ok and max(rel_w, rel_p, orth) <= tol,
                  f"K4 n={n} batch={batch} {dtype}: rel w {rel_w:.2e} proj {rel_p:.2e} orth {orth:.2e}")
            row = dict(n=n, batch=batch, dtype=str(dtype).split(".")[-1], rel_err_w=rel_w,
                       rel_err_proj=rel_p, orth_err=orth, k4_ms=(k_1 + k_2) / 2,
                       plain_ms=(p1 + p2) / 2, eigh_ms=e_ms)
            rows.append(row)
            print("K4 " + json.dumps(row), flush=True)
            if dtype == torch.float64 and (n, batch) in GRID_BUCKETS:
                at_grid["max_abs_err"] = max(at_grid["max_abs_err"], max_abs)
                at_grid["ms"] += row["k4_ms"]
                at_grid["plain_ms"] += row["plain_ms"]
    report["k4"] = rows
    return at_grid


def _gates(res, vec_len: int, what: str) -> None:
    err = res.info["errRp"]
    finite = bool(
        np.isfinite(res.errRp) and np.isfinite(res.errRd) and np.isfinite(res.relgap)
        and not res.diverged and np.all(np.isfinite(err))
    )
    check(finite, f"{what}: non-finite residuals or divergence")
    check(len(err) >= 2 and err[-1] < err[0], f"{what}: errRp did not decrease ({err[0]} -> {err[-1]})")
    check(res.X.shape == (vec_len,) and bool(np.all(np.isfinite(res.X))), f"{what}: bad X")


KERNEL_OPS = {  # device-op names of each hand-written kernel
    "k1": ("fused_spd_apply_kernel", "sum_partials_kernel"),
    "k4": ("jacobi_eigh_kernel",),
}


def profile_window(solver, timed_ms_per_it: float) -> dict:
    """Trace PROFILE_ITERS iterations with torch.profiler. Device ops count
    kernels, memsets and copies (one stream, so they do not overlap). The
    tracer slows the host, so the busy share is the traced device time per
    iteration over ``timed_ms_per_it`` from the untraced run, and
    ``busy_share_traced`` is the same over the traced wall time."""
    act = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(max_iter=PROFILE_ITERS, stop_tol=0.0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = sorted(
        (e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total,
    )
    dev_us = sum(e.self_device_time_total for e in dev)
    per_it = lambda us: us / 1e3 / PROFILE_ITERS
    out = dict(
        wall_ms_per_it=per_it(wall_us),
        device_ms_per_it=per_it(dev_us),
        busy_share=per_it(dev_us) / timed_ms_per_it,  # 0.0 where the profiler saw no device time
        busy_share_traced=dev_us / wall_us,
        device_ops_per_it=sum(e.count for e in dev) / PROFILE_ITERS,
    )
    for k, names in KERNEL_OPS.items():
        k_us = sum(e.self_device_time_total for e in dev if any(m in e.key for m in names))
        out[f"{k}_ms_per_it"] = per_it(k_us)
        out[f"{k}_share_of_device"] = k_us / dev_us if dev_us else None
    return dict(
        out,
        top_device_ops=[  # [op, self ms per iteration, launches per iteration]
            [e.key.replace("(anonymous namespace)::", "")[:60],
             per_it(e.self_device_time_total), e.count / PROFILE_ITERS]
            for e in dev[:PROFILE_TOP]
        ],
    )


def _methods(solver) -> list:
    """The projection method of each bucket, as the solver resolved it."""
    return [bucket_method(solver._projection, i) for i in range(len(solver.structure.buckets))]


def timed_run(solver, iters: int, warm: int = 100):
    """``warm`` untimed iterations, then ``iters`` timed ones with every
    kernel's launch count set to 0 just before and read just after."""
    solver.solve(max_iter=warm, stop_tol=0.0)
    torch.cuda.synchronize()
    precond_apply.LAUNCHES = jacobi.LAUNCHES = 0
    t0 = time.perf_counter()
    res = solver.solve(max_iter=iters, stop_tol=0.0)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(k1=precond_apply.LAUNCHES, k4=jacobi.LAUNCHES)
    check(res.iterations == iters, f"ran {res.iterations} of {iters} iterations")
    return res, elapsed, counts


def _gate_launches(solver, counts: dict, iters: int, solves: int, what: str) -> None:
    """K1 on every refinement sweep; K4 on every jacobi bucket of every
    iteration, and nowhere else."""
    applies = solver.params.neq.applies
    check(counts["k1"] >= iters * solves * applies,
          f"{what}: K1 launched {counts['k1']} times, fewer than {iters}x{solves}x{applies} sweeps")
    k4_buckets = sum(m == "jacobi" and bk.n > 1
                     for m, bk in zip(_methods(solver), solver.structure.buckets))
    check(counts["k4"] >= iters * k4_buckets and (k4_buckets or counts["k4"] == 0),
          f"{what}: K4 launched {counts['k4']} times for {k4_buckets} jacobi buckets x {iters}")


def _probe_normal_solve(solver, con_num: int) -> float:
    neq = solver.params.neq
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(con_num), device="cuda")
    rhs = aat_matvec(neq.sparse_a, v)
    resid = float(neq.residual_norm(rhs, neq.solve(rhs)))
    check(resid < 1e-6, f"normal-solve residual {resid:.3e} on the probe rhs")
    return resid


def standin() -> int:
    n = 1560
    t0 = time.perf_counter()
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    prob, _ = maxcut_chordal(W + W.T)
    print(
        f"stand-in: con_num={prob.con_num} vec_len={prob.vec_len} blocks={len(prob.blk)} "
        f"host_build_s={time.perf_counter() - t0:.2f}"
    )
    launches = None
    for mode, switch, iters in (("admm", 0, 500), ("sgs", 10**9, 200)):
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=switch, stop_tol=0.0)
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == "precond", f"normal solver resolved to {neq.mode!r}, not precond")
        check(neq.inv_l.shape[0] == STANDIN_N_PAD, f"factor n_pad {neq.inv_l.shape[0]}")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, iters)
        _gates(res, prob.vec_len, f"stand-in {mode}")
        _gate_launches(solver, counts, iters, 1 if mode == "admm" else 2, f"stand-in {mode}")
        if mode == "admm":
            launches = counts["k1"]
        emit(f"stand-in {mode}", dict(
            it_per_s=iters / elapsed, init_s=init_s, methods=_methods(solver),
            applies=neq.applies, launches=counts, residual_norm=resid,
            errRp_first=float(res.info["errRp"][0]), errRp_last=float(res.info["errRp"][-1]),
            init_breakdown=solver.init_breakdown,
            profile=profile_window(solver, elapsed * 1e3 / iters),
        ))
        del solver, neq, res
        torch.cuda.empty_cache()
    return launches


def grid_problem():
    rows, cols = GRID
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    return maxcut_chordal((W + W.T).tocsr())[0]


def host_syncs_per_iteration(solver) -> dict:
    """Synchronizing calls per iteration inside the chunk loop: the warnings
    of torch's sync debug mode over a 2k-iteration solve less those over a
    k-iteration one (each one chunk; the difference drops the solve's fixed
    start and end). A first k-iteration solve, not counted, settles the
    caching allocator, whose own synchronizing calls would count once."""
    counts = []
    for iters in (SYNC_ITERS, SYNC_ITERS, 2 * SYNC_ITERS):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                solver.solve(max_iter=iters, stop_tol=0.0)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("synchroniz" in str(w.message) for w in caught))
    return dict(per_it=(counts[2] - counts[1]) / SYNC_ITERS, per_solve=counts)


def grid() -> int:
    t0 = time.perf_counter()
    prob = grid_problem()
    emit("grid problem", dict(
        graph=f"{GRID[0]}x{GRID[1]} grid", con_num=prob.con_num, vec_len=prob.vec_len,
        blocks=len(prob.blk), host_build_s=time.perf_counter() - t0))
    launches = None
    rates = {}
    runs = [("jacobi", 0), ("poly", 0), ("eigh", 0), ("auto", 0), ("auto", 128)]
    for proj, pack_to in runs:
        what = f"grid {proj} pack_to={pack_to}"
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=0, stop_tol=0.0,
                           projection=proj, pack_to=pack_to)
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == "precond", f"{what}: normal solver resolved to {neq.mode!r}")
        check(neq.inv_l.shape[0] == GRID_N_PAD, f"{what}: factor n_pad {neq.inv_l.shape[0]}")
        buckets = [(bk.n, bk.count) for bk in solver.structure.buckets]
        if pack_to == 0:
            check(tuple(buckets) == GRID_BUCKETS, f"{what}: buckets {buckets}")
        if proj != "auto":
            check(set(_methods(solver)) == {proj}, f"{what}: methods {_methods(solver)}")
        resid = _probe_normal_solve(solver, prob.con_num)
        res, elapsed, counts = timed_run(solver, GRID_ITERS, GRID_WARM)
        _gates(res, prob.vec_len, what)
        _gate_launches(solver, counts, GRID_ITERS, 1, what)
        if proj == "jacobi":
            launches = counts["k4"]
        rates[(proj, pack_to)] = GRID_ITERS / elapsed
        out = dict(
            it_per_s=GRID_ITERS / elapsed, init_s=init_s, buckets=buckets,
            methods=_methods(solver), applies=neq.applies, launches=counts,
            residual_norm=resid, errRp_first=float(res.info["errRp"][0]),
            errRp_last=float(res.info["errRp"][-1]), init_breakdown=solver.init_breakdown,
            host_syncs=host_syncs_per_iteration(solver),
        )
        if proj in ("jacobi", "eigh"):
            out["profile"] = profile_window(solver, elapsed * 1e3 / GRID_ITERS)
        emit(what, out)
        del solver, neq, res
        torch.cuda.empty_cache()
    emit("grid auto it/s by pack_to", {str(k[1]): v for k, v in rates.items() if k[0] == "auto"})
    return launches


def certified() -> None:
    blk = [("s", 6), ("s", 4), ("s", 6)]
    prob, _, _, _, opt = random_certified_sdp(blk, con_num=12, seed=3)
    cfg = SolverConfig(verbose=False, check_every=25, normal_solver="precond", switch_admm=10**9)
    res = SDPSolver(prob, cfg, device="cuda").solve(max_iter=6000, stop_tol=1e-6)
    check(res.converged, f"certified SDP did not converge: {res.message}")
    gap_p = abs(res.pobj - opt) / (1 + abs(opt))
    gap_d = abs(res.dobj - opt) / (1 + abs(opt))
    check(gap_p < 1e-4 and gap_d < 1e-4, f"certified optimum off: {gap_p:.2e} {gap_d:.2e}")
    print(f"certified: iterations={res.iterations} pobj={res.pobj:.10f} optimum={opt:.10f}")


def main() -> None:
    kind = card()
    build_kernels()
    k1 = compare_k1()
    k4 = compare_k4()
    k1_launches = standin()
    k4_launches = grid()
    certified()
    kernels = {"kernels": [
        dict(name="fused_spd_apply", route="cuda", source="cuadmm_tpu_torch/csrc/precond_apply.cu",
             replaces="cuadmm_tpu/ops/precond_apply.py:64", launches=k1_launches, **k1),
        dict(name="jacobi_eigh", route="cuda", source="cuadmm_tpu_torch/csrc/jacobi_eigh.cu",
             replaces="cuadmm_tpu/ops/jacobi.py:147", launches=k4_launches, **k4),
    ]}
    report.update(kernels)
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(report, indent=1))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
