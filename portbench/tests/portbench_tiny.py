"""The tiny cell the benchmark's tests add to a throwaway copy of it, and a
way to run a copy's tiny cell in a fresh process."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# Tiny sizes gain nothing from threads, and the test workers share the cores.
ENV = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
TINY = "tiny_maxcut.sgs"
TINY_METRIC = "tiny.device_share_of_layers"
TINY_E2E = "tiny_solves"


def add_tiny_cell(root: Path, dtype: str = "float64", overwrite: bool = False) -> None:
    """Add to the copy at ``root`` a configuration, a cell, an end-to-end
    and a per-layer metric and a layer, each as a new file with a new
    manifest entry,
    editing no file of the benchmark; ``overwrite`` rewrites the tiny
    cell's own file alone, in ``dtype``."""
    pkg = root / "portbench"
    man = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((pkg / "configs" / "gset_g11_chordal.json").read_text())
    cfg.update(name="tiny_maxcut", generator_params=dict(rows=10, cols=4))
    (pkg / "configs" / "tiny_maxcut.json").write_text(json.dumps(cfg))
    wl = json.loads((pkg / "workloads" / "gset_g11_chordal.sgs.json").read_text())
    # Limits of its own: the program's CPU path at this size reads gaps of
    # 1e-8 (iterate) and 4e-9 (info); its float32 path 8e-6 and 1.3e-6.
    wl.update(name=TINY, config="tiny_maxcut", dtype=dtype, max_iter=60,
              limits=dict(iterate_gap=1e-6, info_gap=1e-7))
    (pkg / "workloads" / f"{TINY}.json").write_text(json.dumps(wl))
    if overwrite:
        return
    (pkg / "metrics" / f"{TINY_METRIC}.py").write_text(
        "def read(ctx):\n    return float(len(ctx.layer_s) - 1)  # the layers, not \"unmatched\"\n")
    (pkg / "metrics" / f"{TINY_E2E}.py").write_text("def read(window):\n    return float(len(window.results))\n")
    (pkg / "layers" / "tiny_layer.json").write_text(json.dumps(
        dict(layer="tiny layer", rank=9, modules=[], kernels=["no_such_kernel"])))
    man["configs"].append(dict(name="tiny_maxcut", source="a test", file="portbench/configs/tiny_maxcut.json",
                               reduced=["generator_params"], why="a test"))
    man["workloads"].append(dict(name=TINY, config="tiny_maxcut", traffic="sgs", chips=1, why="a test"))
    man["end_to_end"].append(dict(name=TINY_E2E, unit="count", better="higher", bound=0.25, source="host_clock",
                                  workloads=[TINY]))
    man["per_layer"].append(dict(name=TINY_METRIC, unit="count", better="higher", source="device_trace",
                                 layer="tiny layer", moves="it_per_s", workloads=[TINY]))
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def run_copy(root: Path, plant: str = "", trace: bool = False, device: str = "cpu", timeout: int = 600):
    """Run the tiny cell of the copy at ``root`` through ``harness.run_cell``
    in a fresh process, after the code ``plant`` (a fault planted in the
    program), skipping run.py's look for a card: (exit code, result)."""
    code = "\n".join([
        "import json, sys, warnings",
        "warnings.simplefilter('ignore')",
        f"sys.path[:0] = [{str(root)!r}, {str(REPO)!r}]",
        "import torch",
        plant,
        "from portbench import harness",
        f"rc, out = harness.run_cell({TINY!r}, 2**31 + 12345, 0.3, {trace!r}, {device!r})",
        "print('RESULT ' + json.dumps(dict(rc=rc, out=out)))",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=timeout,
                          env=ENV)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(lines[-1][len("RESULT "):])
    return res["rc"], res["out"]
