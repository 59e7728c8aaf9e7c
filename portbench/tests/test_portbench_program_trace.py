"""program_trace.py's attribution of device ops to the program's layer
spans, on synthetic events, and the eight readers that rest on it, on the
tiny cell's program on the CPU and on a program without the trace
module."""

from __future__ import annotations

import importlib.util
import json
from types import SimpleNamespace

import pytest

from portbench import program_trace
from portbench_tiny import REPO

READERS = ["normal_solve.launched_ms_per_it", "projection.launched_ms_per_it", "ell_products.launched_ms_per_it",
           "algebra.launched_ms_per_it", "driver.start_ms_per_solve", "driver.chunk_gap_ms",
           "normal_solve.sweeps_per_it", "driver.graph_launches_per_it"]
LAYER_READERS = READERS[:4]

# One iteration as the program traces it with layers on: the step's
# algebra span around the others; each layer's graph part launched inside
# its span (correlation ids 1-6); a copy launched outside every span (7);
# a kernel whose launch the trace lost (8). Times in us.
SPANS = [("algebra", 0, 100), ("ell_products", 10, 20), ("normal_solve", 20, 50), ("projection", 60, 90),
         ("algebra", 200, 300), ("ell_products", 210, 220)]
LAUNCHES = [(1, 1, 2), (2, 11, 12), (3, 21, 22), (4, 55, 56), (5, 61, 62), (6, 211, 212), (7, 150, 151)]
OPS = [("k_alg", 100, 1100, 1), ("gather", 1100, 1400, 2), ("K1", 1400, 4400, 3), ("add", 4400, 4700, 4),
       ("gemm", 4700, 9700, 5), ("gather", 9700, 9900, 6), ("gather", 9900, 10000, 6),
       ("Memcpy DtoD", 10000, 10010, 7)]


def _metric(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_each_op_goes_to_the_innermost_span_that_holds_its_launch():
    ms = program_trace.attribute(OPS, LAUNCHES, SPANS)
    assert ms == pytest.approx(dict(algebra=1.3, ell_products=0.6, normal_solve=3.0, projection=5.0,
                                    other=0.01, unlinked=0.0))
    lost = program_trace.attribute(OPS + [("k", 10000, 10500, 8)], LAUNCHES, SPANS)
    assert lost["unlinked"] == pytest.approx(0.5)


@pytest.mark.parametrize("unlinked_us", [0, 100, 200])
def test_a_layer_reader_reads_nothing_past_one_percent_unlinked(unlinked_us):
    """10 ms of device time over 2 iterations: 0.1 ms unlinked is 1% (read),
    0.2 ms is past it (None)."""
    ms = program_trace.attribute(OPS, LAUNCHES, SPANS)
    total = sum(ms.values()) + unlinked_us / 1e3
    layers = {k: v / 2 for k, v in dict(ms, unlinked=unlinked_us / 1e3).items()}
    ctx = SimpleNamespace(program_trace=SimpleNamespace(layers=dict(layers, device_ms_per_it=total / 2)))
    got = [_metric(m).read(ctx) for m in LAYER_READERS]
    if unlinked_us > 0.01 * total * 1e3:
        assert got == [None] * 4
    else:
        assert got == pytest.approx([1.5, 2.5, 0.3, 0.65])


def test_the_manifest_lists_each_reader_in_both_cells():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == ["gset_g11_chordal.sgs", "quasar500.sgs"]
        assert entries[name]["moves"] == "it_per_s" and entries[name]["better"] == "lower"
        assert (REPO / "portbench" / "metrics" / f"{name}.py").is_file()


def _tiny_ctx():
    import torch

    from portbench.entries import sdp_solve
    from portbench.generators import toroidal_maxcut

    cfg = json.loads((REPO / "portbench" / "configs" / "gset_g11_chordal.json").read_text())
    prob = toroidal_maxcut.generate(dict(rows=6, cols=4), 2**31 + 7)
    settings = dict(cfg["solver"], check_every=5, dtype="float64")
    program = sdp_solve.build(prob, settings, torch.device("cpu"))
    program.solve(5, 0.0)
    return SimpleNamespace(program=program, workload=dict(max_iter=20), stop_tol=0.0, sync=lambda: None,
                           device=torch.device("cpu"))


def test_the_readers_on_the_tiny_program_on_the_cpu(monkeypatch):
    """The counters and the driver's spans read on the CPU (the plain
    runner launches no graph; the gaps are the host's); the CPU has no
    device ops, so the layer readers read nothing. A program without the
    trace module gives None everywhere."""
    monkeypatch.setattr("portbench.harness.TRACE_ITER", 20)
    ctx = _tiny_ctx()
    got = {m: _metric(m).read(ctx) for m in READERS}
    applies = ctx.program.solver.params.neq.applies
    assert got["normal_solve.sweeps_per_it"] == 2 * applies  # sGS: two normal solves an iteration
    assert got["driver.graph_launches_per_it"] == 0.0
    assert got["driver.start_ms_per_solve"] > 0 and got["driver.chunk_gap_ms"] >= 0
    assert all(got[m] is None for m in LAYER_READERS)
    assert not program_trace._program_trace()._RECORDING  # left off

    monkeypatch.setattr(program_trace, "_program_trace", lambda: None)
    bare = SimpleNamespace(**{k: v for k, v in vars(ctx).items() if k != "program_trace"})
    assert all(_metric(m).read(bare) is None for m in READERS)
