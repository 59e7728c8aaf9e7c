"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernel K1 (csrc/precond_apply.cu) into build/;
3. hold K1 against its plain PyTorch version at n_pad 128, 1024, 17152 and
   32768 (relative error <= 1e-5), with both times from CUDA events;
4. run the stand-in problem (max-cut, chordally decomposed, banded graph
   n=1560 with off-diagonals 1..4: 17,110 constraints, 1,556 5x5 blocks)
   through SDPSolver in float64 with normal_solver and projection "auto":
   100 warm iterations, 500 timed plain-ADMM iterations, 200 sGS
   iterations, gated on finite and decreasing residuals and on K1 having
   run on every refinement sweep; then 50 more iterations of each mode
   under torch.profiler for the device busy share, the device ops per
   iteration, K1's share and the costliest device ops;
5. solve a certified random SDP to 1e-6 and match its known optimum.

The next-to-last line is the kernel table as JSON, the last line
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import cuadmm_tpu_torch  # noqa: F401  (first: fails alone, without the repo)

import json
import subprocess
import time

import numpy as np
import scipy.sparse as sp
import torch

from cuadmm_tpu_torch import SDPSolver, SolverConfig, _build
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.ops import precond_apply
from cuadmm_tpu_torch.ops.sparse import aat_matvec

K1_SIZES = (128, 1024, 17152, 32768)
K1_REL_TOL = 1e-5  # f32 sums taken in another order than cuBLAS's
K1_REPS = 20
STANDIN_N_PAD = 17152  # the stand-in's padded factor: the main path's K1 shape
PROFILE_ITERS = 50
PROFILE_TOP = 10  # device ops listed per mode, by self time


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(out)
    return torch.cuda.get_device_name(0)


def build_k1() -> None:
    t0 = time.perf_counter()
    path = _build.build("precond_apply")
    print(f"K1 build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())


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
        if n == STANDIN_N_PAD:
            at_main_shape = dict(max_abs_err=max_abs, ms=k_ms, plain_ms=p_ms)
        del m, r, y, ref
        torch.cuda.empty_cache()
    return at_main_shape


def _gates(res, vec_len: int, what: str) -> None:
    err = res.info["errRp"]
    finite = bool(
        np.isfinite(res.errRp) and np.isfinite(res.errRd) and np.isfinite(res.relgap)
        and not res.diverged and np.all(np.isfinite(err))
    )
    check(finite, f"{what}: non-finite residuals or divergence")
    check(len(err) >= 2 and err[-1] < err[0], f"{what}: errRp did not decrease ({err[0]} -> {err[-1]})")
    check(res.X.shape == (vec_len,) and bool(np.all(np.isfinite(res.X))), f"{what}: bad X")


def _is_k1(key: str) -> bool:
    return "fused_spd_apply_kernel" in key or "sum_partials_kernel" in key


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
    k1_us = sum(e.self_device_time_total for e in dev if _is_k1(e.key))
    per_it = lambda us: us / 1e3 / PROFILE_ITERS
    return dict(
        wall_ms_per_it=per_it(wall_us),
        device_ms_per_it=per_it(dev_us),
        busy_share=per_it(dev_us) / timed_ms_per_it,  # 0.0 where the profiler saw no device time
        busy_share_traced=dev_us / wall_us,
        device_ops_per_it=sum(e.count for e in dev) / PROFILE_ITERS,
        k1_ms_per_it=per_it(k1_us),
        k1_share_of_device=k1_us / dev_us if dev_us else None,
        top_device_ops=[  # [op, self ms per iteration, launches per iteration]
            [e.key.replace("(anonymous namespace)::", "")[:60],
             per_it(e.self_device_time_total), e.count / PROFILE_ITERS]
            for e in dev[:PROFILE_TOP]
        ],
    )


def standin() -> int:
    n = 1560
    t0 = time.perf_counter()
    W = sp.diags([np.ones(n - k) for k in (1, 2, 3, 4)], [1, 2, 3, 4], shape=(n, n))
    prob, _ = maxcut_chordal(W + W.T)
    print(
        f"stand-in: con_num={prob.con_num} vec_len={prob.vec_len} blocks={len(prob.blk)} "
        f"host_build_s={time.perf_counter() - t0:.2f}"
    )
    results = {}
    launches = None
    for mode, switch, iters in (("admm", 0, 500), ("sgs", 10**9, 200)):
        cfg = SolverConfig(verbose=False, check_every=100, switch_admm=switch, stop_tol=0.0)
        t0 = time.perf_counter()
        solver = SDPSolver(prob, cfg, device="cuda")
        init_s = time.perf_counter() - t0
        neq = solver.params.neq
        check(neq.mode == "precond", f"normal solver resolved to {neq.mode!r}, not precond")
        check(solver._projection == "eigh", f"projection resolved to {solver._projection!r}")
        check(neq.inv_l.shape[0] == STANDIN_N_PAD, f"factor n_pad {neq.inv_l.shape[0]}")
        rng = np.random.default_rng(1)
        v = torch.as_tensor(rng.standard_normal(prob.con_num), device="cuda")
        rhs = aat_matvec(neq.sparse_a, v)
        resid = float(neq.residual_norm(rhs, neq.solve(rhs)))
        check(resid < 1e-6, f"normal-solve residual {resid:.3e} on the probe rhs")

        solver.solve(max_iter=100, stop_tol=0.0)  # warm-up
        torch.cuda.synchronize()
        precond_apply.LAUNCHES = 0
        t0 = time.perf_counter()
        res = solver.solve(max_iter=iters, stop_tol=0.0)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        count = precond_apply.LAUNCHES
        _gates(res, prob.vec_len, f"stand-in {mode}")
        solves = 1 if mode == "admm" else 2
        check(res.iterations == iters, f"{mode}: ran {res.iterations} of {iters} iterations")
        check(count >= iters * solves * neq.applies,
              f"{mode}: K1 launched {count} times, fewer than {iters}x{solves}x{neq.applies} sweeps")
        if mode == "admm":
            launches = count
        results[mode] = dict(
            it_per_s=iters / elapsed, init_s=init_s, applies=neq.applies, k1_launches=count,
            residual_norm=resid, errRp_first=float(res.info["errRp"][0]),
            errRp_last=float(res.info["errRp"][-1]), init_breakdown=solver.init_breakdown,
            profile=profile_window(solver, elapsed * 1e3 / iters),
        )
        print(f"stand-in {mode}: " + json.dumps(results[mode]))
        del solver, neq, res
        torch.cuda.empty_cache()
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
    build_k1()
    k1 = compare_k1()
    launches = standin()
    certified()
    print(json.dumps({"kernels": [dict(
        name="fused_spd_apply",
        route="cuda",
        source="cuadmm_tpu_torch/csrc/precond_apply.cu",
        replaces="cuadmm_tpu/ops/precond_apply.py:64",
        launches=launches,
        **k1,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
