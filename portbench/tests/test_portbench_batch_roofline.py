"""batch.k1_roofline on synthetic traces: the same batch sweeps read the
same share whatever the launch layout, and a missing input reads None."""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench.trace import Trace  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
N_PAD = 18_816


def _reader():
    path = REPO / "portbench" / "metrics" / "batch.k1_roofline.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_batch_k1_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(kernel: str, launches: int, rhs, ms_each: float, facts=None):
    """A traced solve of ``launches`` K1 launches of ``ms_each`` ms each
    (the apply kernel, then its sum), between other device work."""
    ops, t = [], 0.0
    for _ in range(launches):
        ops.append((kernel, t, t + ms_each * 1e3 * 0.99))
        ops.append(("sum_partials_kernel", t + ms_each * 1e3 * 0.99, t + ms_each * 1e3))
        ops.append(("jacobi_cta_kernel<double>", t + ms_each * 1e3, t + ms_each * 1e3 + 5.0))
        t += ms_each * 1e3 + 5.0
    tr = Trace(device_ops=ops, host_ops=[], window=(0.0, t), window_s=t * 1e-6, busy_s=t * 1e-6, iterations=1)
    bt = None if rhs is None else SimpleNamespace(k1_rhs_per_launch=rhs)
    return SimpleNamespace(trace=tr, facts=dict(n_pad=N_PAD, instances=8) if facts is None else facts, kind=H100,
                           batch_trace=bt)


def test_bound_of_a_batch_sweep():
    mod = _reader()
    # 708.1 MB of triangle and 1.2 MB of R and Y at 3.35 TB/s; the flops,
    # 5.67 GFLOP at 67 TFLOP/s, take 0.085 ms.
    assert mod.sweep_bound_s(N_PAD, 8, H100) * 1e3 == pytest.approx(0.2117, abs=5e-5)
    assert mod.sweep_bound_s(N_PAD, 1, H100) * 1e3 == pytest.approx(0.2114, abs=5e-5)
    assert mod.sweep_bound_s(N_PAD, 8, "a card with no peaks") is None
    tri = N_PAD * (N_PAD + 1) // 2
    assert mod.sweep_bound_s(128, 4096, H100) == pytest.approx(4 * 4096 * (128 * 129 // 2) / 67e12)
    assert 4 * tri == 708_121_344


@pytest.mark.parametrize("sweeps", [1, 10])
def test_one_rhs_and_eight_rhs_launches_of_the_same_work_read_the_same_bound(sweeps):
    """80 launches of one right-hand side and 10 of eight are 10 batch
    sweeps of 8 instances: at the same device time, the same share."""
    mod = _reader()
    one = mod.read(_ctx("fused_spd_apply_kernel<1>", 8 * sweeps, 1.0, 0.25))
    eight = mod.read(_ctx("fused_spd_apply_kernel_rhs<4, 4>", sweeps, 8.0, 2.0))
    bound = mod.sweep_bound_s(N_PAD, 8, H100)
    assert one == pytest.approx(eight) == pytest.approx(100.0 * sweeps * bound / (sweeps * 2.0e-3))
    # The parent's layout at its measured 0.247 ms a launch: about 10.7%.
    assert mod.read(_ctx("fused_spd_apply_kernel<1>", 80, 1.0, 0.247)) == pytest.approx(10.71, abs=0.01)


@pytest.mark.parametrize("case", ["no_n_pad", "no_instances", "no_counter", "no_launch", "no_peaks"])
def test_missing_inputs_read_none(case):
    mod = _reader()
    ctx = _ctx("fused_spd_apply_kernel<1>", 8, 1.0, 0.25)
    if case == "no_n_pad":
        ctx.facts = dict(n_pad=None, instances=8)
    elif case == "no_instances":
        ctx.facts = dict(n_pad=N_PAD)
    elif case == "no_counter":
        ctx.batch_trace = None
    elif case == "no_launch":
        ctx = _ctx("fused_spd_apply_kernel<1>", 0, 1.0, 0.25)
    else:
        ctx.kind = "a card with no peaks"
    assert mod.read(ctx) is None
