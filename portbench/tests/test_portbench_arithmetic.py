"""The yardstick's arithmetic: K1's bound, the trace reduction and the
comparison."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench import compare, roofline  # noqa: E402
from portbench.trace import Trace, short_name  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("n_pad, ms", [(17_152, 0.1757), (18_816, 0.2114)])
def test_k1_bound(n_pad, ms):
    # The f32 triangle of n_pad rows, r and y, at 3.35 TB/s: 588.4 MB at
    # 17,152 rows; 708.3 MB at 18,816, the G11 cell's 18,692 constraints.
    assert roofline.k1_launch_bytes(n_pad) == n_pad * (n_pad + 1) // 2 * 4 + 2 * n_pad * 4
    assert roofline.k1_bound_s(n_pad, H100) * 1e3 == pytest.approx(ms, abs=5e-5)
    assert roofline.k1_bound_s(n_pad, "a card with no peaks") is None


def _trace():
    dev = [("fused_spd_apply_kernel", 0.0, 10.0), ("sum_partials_kernel", 10.0, 12.0),
           ("sm90_xmma_gemm_f64f64", 11.0, 20.0), ("void at::native::vectorized_elementwise_kernel<4>(int)", 30.0, 35.0),
           ("fused_spd_apply_kernel", 60.0, 70.0)]
    host = [("cudaGraphLaunch", 0.0, 1.0), ("aten::copy_", 20.0, 29.0), ("aten::to", 40.0, 50.0)]
    return Trace(device_ops=dev, host_ops=host, window=(0.0, 100.0), window_s=100e-6, busy_s=35e-6, iterations=2)


def test_trace_reduction():
    tr = _trace()
    assert tr.device_s() == pytest.approx(36e-6)
    assert tr.count("fused_spd_apply_kernel") == 2
    layers = {"normal_solve": ["fused_spd_apply_kernel", "sum_partials_kernel"], "projection": ["GEMM"],
              "algebra": ["elementwise_kernel"]}
    got = tr.layer_s(layers)
    assert got == pytest.approx(dict(normal_solve=22e-6, projection=9e-6, algebra=5e-6, unmatched=0.0))
    gaps = tr.idle_gaps()
    assert gaps[0] == ["host after the call's last device op", pytest.approx(30e-6)]  # 70-100
    assert gaps[1] == ["aten::to", pytest.approx(25e-6)]  # 35-60, its middle in aten::to
    assert gaps[2] == ["aten::copy_", pytest.approx(10e-6)]  # 20-30
    assert tr.top_ops()[0] == ["fused_spd_apply_kernel", pytest.approx(20e-6)]
    assert short_name("void at::native::vectorized_elementwise_kernel<4, F<double> >(int, F<double>)") == \
        "at::native::vectorized_elementwise_kernel<4, F<double> >"


def _res(n=5, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    return dict(X=rng.standard_normal(n), y=rng.standard_normal(3), S=rng.standard_normal(n),
                info=np.abs(rng.standard_normal((rows, 8))), iterations=rows)


def test_comparison():
    ref = _res()
    assert compare.gaps(ref, ref) == dict(iterate_gap=0.0, info_gap=0.0)
    off = dict(ref, X=ref["X"] * (1 + 1e-6))
    assert compare.gaps(off, ref)["iterate_gap"] == pytest.approx(1e-6)
    short = _res(rows=3)
    assert compare.gaps(short, ref) == dict(iterate_gap=compare.UNCOMPARABLE, info_gap=compare.UNCOMPARABLE)
    nan = dict(ref, y=ref["y"] * np.nan)
    assert compare.gaps(nan, ref)["iterate_gap"] == compare.UNCOMPARABLE
    checks = compare.judge([ref, off], ref, {"iterate_gap": 1e-7, "info_gap": 1e-7})
    assert checks["iterate_gap"] == dict(value=pytest.approx(1e-6), limit=1e-7)
