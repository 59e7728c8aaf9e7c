"""projection.tri_products_per_it on tiny programs on the CPU: 40 triangle
products an iteration where QUASAR's one block takes the poly filter's
one-triangle route, 0 on the max-cut cell's buckets, None on a program
without the counter."""

from __future__ import annotations

import importlib
import importlib.util
import json
from types import SimpleNamespace

from portbench_tiny import REPO

NAME = "projection.tri_products_per_it"


def _reader():
    spec = importlib.util.spec_from_file_location("m_tri", REPO / "portbench" / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ctx(generator, params, config, **solver):
    import torch

    from portbench.entries import sdp_solve

    cfg = json.loads((REPO / "portbench" / "configs" / f"{config}.json").read_text())
    gen = importlib.import_module(f"portbench.generators.{generator}")
    prob = gen.generate(dict(cfg["generator_params"], **params), 2**31 + 11)
    settings = dict(cfg["solver"], check_every=5, dtype="float64", **solver)
    program = sdp_solve.build(prob, settings, torch.device("cpu"))
    program.solve(5, 0.0)
    return SimpleNamespace(program=program, workload=dict(max_iter=10), stop_tol=0.0, sync=lambda: None,
                           device=torch.device("cpu"))


def test_the_manifest_lists_the_reader_in_both_cells():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(m for m in man["per_layer"] if m["name"] == NAME)
    assert entry == dict(name=NAME, unit="count/it", better="lower", source="program_counter", layer="projection",
                         moves="it_per_s", workloads=["gset_g11_chordal.sgs", "quasar500.sgs"])


def test_quasar_block_on_the_route_reads_40(monkeypatch):
    from cuadmm_tpu_torch.ops import polyfilter

    monkeypatch.setattr(polyfilter, "TRI_MIN_N", dict.fromkeys(polyfilter.TRI_MIN_N, 8))
    ctx = _ctx("quasar", dict(n_poses=3), "quasar500", projection="poly")
    assert _reader().read(ctx) == 40.0


def test_max_cut_buckets_read_0_and_a_program_without_the_counter_none(monkeypatch):
    from cuadmm_tpu_torch import trace

    ctx = _ctx("toroidal_maxcut", dict(rows=6, cols=4), "gset_g11_chordal")
    assert _reader().read(ctx) == 0.0
    monkeypatch.setattr(trace, "COUNTS", {k: v for k, v in trace.COUNTS.items() if k != "poly_tri_products"})
    assert _reader().read(ctx) is None
