"""The harness on a throwaway copy: a cell, a configuration, an end-to-end
and a per-layer metric and a layer added as new files and manifest
entries run with no file of the benchmark edited; ``correct`` comes out false for the control
(the program's float32 path) and for each fault a solve can have; the run
refuses to report once jax or the JAX package is loaded, and without a
card. The harness's look for a chip is skipped (device "cpu") but for the
test marked cuda."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench_tiny import TINY, TINY_E2E, TINY_METRIC, add_tiny_cell

REPO = Path(__file__).resolve().parents[2]

FROZEN_STEP = """
import cuadmm_tpu_torch.solver.driver as drv
_make_step = drv.make_step
def make_step(**kw):
    step = _make_step(**kw)
    def frozen(state, params, it_host, out=None, eigh=None):
        row = torch.stack([state.pobj, state.dobj, state.errRp, state.errRd, state.relgap, state.sig,
                           params.bscale, params.Cscale], dim=-1)
        return (state if out is None else out), row
    frozen.in_sgs, frozen.key = step.in_sgs, step.key + ("frozen",)
    return frozen
drv.make_step = make_step
"""
ALTERED_ANSWER = """
import numpy as np
import cuadmm_tpu_torch.solver.driver as drv
_unscale = drv.scaling_mod.unscale_solution
def unscale(*a, **kw):
    X, y, S = _unscale(*a, **kw)
    X = X.copy()
    X[0] += 1e-4 * np.linalg.norm(X)
    return X, y, S
drv.scaling_mod.unscale_solution = unscale
"""
JAX_LOADED = "import types; sys.modules['jax'] = types.ModuleType('jax')"


def test_a_throwaway_cell_metric_and_layer_run_as_new_files(bench_copy, run_copy):
    rc, out = run_copy(bench_copy, trace=True)
    assert rc == 0 and out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert out["metrics"][TINY_METRIC]["value"] == 5.0  # four layers of the benchmark and the new one
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(out)[-1] == "checks" and set(out["checks"]) == {"iterate_gap", "info_gap"}
    assert {"busy_s", "window_s", "platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])


def test_end_to_end_metrics_without_trace_and_a_new_ones_reader(bench_copy, run_copy):
    rc, out = run_copy(bench_copy)
    assert rc == 0 and out["correct"] is True
    assert set(out["metrics"]) == {"it_per_s", "setup_s", "peak_mem_gib", TINY_E2E}
    assert out["metrics"][TINY_E2E]["value"] == out["attempted"]
    assert out["metrics"]["it_per_s"]["unit"] == "it/s" and out["metrics"]["it_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", ["frozen_step", "altered_answer"])
def test_each_fault_reads_not_correct(bench_copy, run_copy, fault):
    rc, out = run_copy(bench_copy, plant=dict(frozen_step=FROZEN_STEP, altered_answer=ALTERED_ANSWER)[fault])
    assert rc == 0 and out["correct"] is False, out["checks"]


def test_the_control_reads_not_correct(bench_copy, run_copy):
    """The program's float32 state path, the precision below the cell's
    float64, held to the cell's limits."""
    add_tiny_cell(bench_copy, dtype="float32", overwrite=True)
    rc, out = run_copy(bench_copy)
    assert rc == 0 and out["correct"] is False, out["checks"]


def test_a_run_that_loaded_jax_reports_nothing(bench_copy, run_copy):
    rc, out = run_copy(bench_copy, plant=JAX_LOADED)
    assert rc == 4 and out is None


def test_without_a_card_run_py_exits_without_a_result(bench_copy):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", TINY, "--seed", str(2**31 + 5),
                           "--seconds", "1", "--trace", "0"], cwd=bench_copy, capture_output=True, text=True,
                          timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                                            "PYTHONPATH": str(REPO)})
    assert proc.returncode != 0 and not proc.stdout.strip()


@pytest.mark.cuda
def test_run_py_on_the_card(bench_copy, cuda_card):
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", TINY, "--seed", str(2**31 + 5),
                           "--seconds", "1", "--trace", "1"], cwd=bench_copy, capture_output=True, text=True,
                          timeout=900, env=dict(__import__("os").environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
