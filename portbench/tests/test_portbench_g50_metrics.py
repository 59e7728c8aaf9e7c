"""The readers of the G50 cell's two per-layer metrics.

band.k3_roofline on hand-made traces: the bound counts the RCM band's
own entries whatever tiles K3 streams, one sweep a launch, and a missing
input reads None. projection.poly_gemms_per_it on tiny programs on the
CPU: 40 GEMMs an iteration for each bucket on the poly filter's batched
route, 0 where none takes it, None on a program without the counter.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from types import SimpleNamespace

import pytest

from portbench_tiny import REPO

from portbench.trace import Trace

H100 = "NVIDIA H100 80GB HBM3"
G50_N, G50_BW = 139_192, 4
CELL = "gset_g50_chordal.sgs"


def _reader(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _k3_ctx(kernel: str, solves: int, ms_each: float, bw=G50_BW, con_num=G50_N, kind=H100):
    """A traced solve of ``solves`` K3 solves of two sweeps of ``ms_each``
    ms each (each sweep followed by the epoch bump), between other device
    work."""
    ops, t = [], 0.0
    for _ in range(solves):
        for _ in range(2):
            ops.append((kernel, t, t + ms_each * 1e3))
            ops.append(("epoch_bump_kernel", t + ms_each * 1e3, t + ms_each * 1e3 + 2.0))
            t += ms_each * 1e3 + 2.0
        ops.append(("jacobi_cta_kernel<double>", t, t + 5.0))
        t += 5.0
    tr = Trace(device_ops=ops, host_ops=[], window=(0.0, t), window_s=t * 1e-6, busy_s=t * 1e-6, iterations=1)
    breakdown = {} if bw is None else {"neq.band_bw": bw, "neq.band_layout": "nb=272 nbw=1 B=512"}
    program = SimpleNamespace(init_breakdown=breakdown,
                              solver=SimpleNamespace(problem=SimpleNamespace(con_num=con_num)))
    return SimpleNamespace(trace=tr, program=program, facts={}, kind=kind)


def test_the_manifest_lists_both_readers_in_the_g50_cell():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    got = {m["name"]: m for m in man["per_layer"]}
    assert got["band.k3_roofline"] == dict(
        name="band.k3_roofline", unit="%", better="higher", source="device_trace", layer="normal solve",
        moves="it_per_s", workloads=[CELL])
    assert got["projection.poly_gemms_per_it"] == dict(
        name="projection.poly_gemms_per_it", unit="count/it", better="lower", source="program_counter",
        layer="projection", moves="it_per_s", workloads=[CELL])


def test_k3_bound_counts_the_bands_own_entries():
    mod = _reader("band.k3_roofline")
    # G50: 139,192 rows of 5 f32 entries (3.88 MB) and r and y (1.11 MB)
    # at 3.35 TB/s: 1.163 us a sweep, against the 570 MB of 512-row tiles
    # K3 streams a sweep.
    assert mod.sweep_bytes(G50_N, G50_BW) == 4 * G50_N * 5 + 8 * G50_N == 3_897_376
    assert mod.sweep_bound_s(G50_N, G50_BW, H100) * 1e6 == pytest.approx(1.1634, abs=1e-4)
    assert mod.sweep_bound_s(G50_N, G50_BW, "a card with no peaks") is None


@pytest.mark.parametrize("kernel", ["chain_sweep_kernel<512, 4>", "tri_sweep_kernel<true>"])
@pytest.mark.parametrize("solves", [1, 40])
def test_k3_roofline_is_the_bound_of_each_sweep_over_the_sweeps_time(kernel, solves):
    """Either form's sweeps, at the fitted model's 0.48 ms a sweep (0.963
    ms a solve): about 0.24%, whatever the number of solves; the epoch
    bumps and the other kernels are left out of the time."""
    mod = _reader("band.k3_roofline")
    got = mod.read(_k3_ctx(kernel, solves, 0.4815))
    bound = mod.sweep_bound_s(G50_N, G50_BW, H100)
    want = 100.0 * (2 * solves) * bound / (2 * solves * 0.4815e-3)
    assert got == pytest.approx(want) == pytest.approx(0.2416, abs=1e-4)
    # At the bound itself: 100%.
    assert mod.read(_k3_ctx(kernel, solves, bound * 1e3)) == pytest.approx(100.0)


@pytest.mark.parametrize("case", ["no_band", "no_launch", "no_peaks", "no_solver"])
def test_k3_roofline_missing_inputs_read_none(case):
    mod = _reader("band.k3_roofline")
    if case == "no_band":  # precond or split: no band probe, no K3
        ctx = _k3_ctx("chain_sweep_kernel<512, 4>", 3, 0.5, bw=None)
    elif case == "no_launch":
        ctx = _k3_ctx("fused_spd_apply_kernel<1>", 3, 0.5)
    elif case == "no_peaks":
        ctx = _k3_ctx("chain_sweep_kernel<512, 4>", 3, 0.5, kind="a card with no peaks")
    else:  # a program without an SDPSolver
        ctx = _k3_ctx("chain_sweep_kernel<512, 4>", 3, 0.5)
        ctx.program = SimpleNamespace(init_breakdown={"neq.band_bw": 4})
    assert mod.read(ctx) is None


def _program_ctx(rows, cols, **solver):
    import torch

    from portbench.entries import sdp_solve
    from portbench.generators import toroidal_maxcut

    cfg = json.loads((REPO / "portbench" / "configs" / "gset_g50_chordal.json").read_text())
    prob = toroidal_maxcut.generate(dict(rows=rows, cols=cols), 2**31 + 13)
    settings = dict(cfg["solver"], check_every=5, dtype="float64", **solver)
    program = sdp_solve.build(prob, settings, torch.device("cpu"))
    program.solve(5, 0.0)
    return SimpleNamespace(program=program, workload=dict(max_iter=10), stop_tol=0.0, sync=lambda: None,
                           device=torch.device("cpu"))


def test_poly_gemms_read_40_a_poly_bucket_and_none_without_the_counter(monkeypatch):
    """A 5 x 6 torus has two buckets (8 and 16): on poly both take the
    batched route, 80 GEMMs an iteration; on jacobi none."""
    from cuadmm_tpu_torch import trace

    mod = _reader("projection.poly_gemms_per_it")
    assert mod.read(_program_ctx(5, 6, projection="poly")) == 80.0
    ctx = _program_ctx(5, 6, projection="jacobi")
    assert mod.read(ctx) == 0.0
    monkeypatch.setattr(trace, "COUNTS", {k: v for k, v in trace.COUNTS.items() if k != "poly_gemm_products"})
    assert mod.read(ctx) is None


def test_each_route_reader_reads_its_own_counter_when_readers_are_shared(monkeypatch):
    """The two projection readers on one program whose buckets all take the
    batched route, with the harness handing out one module a metric (as a
    cache would): the GEMM reader reads 80, the triangle reader 0."""
    import functools

    from portbench import harness

    monkeypatch.setattr(harness, "load_metric", functools.cache(harness.load_metric))
    tri = harness.load_metric("projection.tri_products_per_it")
    gemm = harness.load_metric("projection.poly_gemms_per_it")
    ctx = _program_ctx(5, 6, projection="poly")
    assert gemm.read(ctx) == 80.0
    assert harness.load_metric("projection.tri_products_per_it").read(ctx) == tri.read(ctx) == 0.0
