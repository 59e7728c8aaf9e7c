"""What the benchmark's modules load, each in a fresh process: never jax,
jaxlib, flax or the JAX package (top-level names compared whole, since
cuadmm_tpu_torch begins with cuadmm_tpu), and, for the yardstick, nothing
of the program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench_tiny import ENV, REPO

PKG = REPO / "portbench"
MODULES = sorted(
    "portbench." + p.relative_to(PKG).with_suffix("").as_posix().replace("/", ".").replace(".__init__", "")
    for p in PKG.rglob("*.py") if "tests" not in p.parts and "metrics" not in p.parts)
# The yardstick: generators, the reference, the comparison, the roofline
# arithmetic and the trace reduction.
YARDSTICK = [m for m in MODULES if m.startswith(("portbench.generators", "portbench.reference"))] + [
    "portbench.compare", "portbench.roofline", "portbench.trace", "portbench.problem"]


def _top_level_after_import(modules, files=()) -> set:
    code = "\n".join([
        "import importlib, importlib.util, json, sys",
        f"sys.path[:0] = [{str(REPO)!r}]",
        f"for m in {list(modules)!r}: importlib.import_module(m)",
        f"for i, f in enumerate({[str(f) for f in files]!r}):",
        "    spec = importlib.util.spec_from_file_location(f'reader{i}', f)",
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))",
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    loaded = _top_level_after_import(MODULES, sorted((PKG / "metrics").glob("*.py")))
    assert "portbench" in loaded and "cuadmm_tpu_torch" in loaded  # the entries load the program
    assert not loaded & {"jax", "jaxlib", "flax", "cuadmm_tpu"}, loaded & {"jax", "jaxlib", "flax", "cuadmm_tpu"}


@pytest.mark.parametrize("module", YARDSTICK)
def test_the_yardstick_loads_nothing_of_the_program(module):
    loaded = _top_level_after_import([module])
    assert "cuadmm_tpu_torch" not in loaded and not loaded & {"jax", "jaxlib", "flax", "cuadmm_tpu"}
