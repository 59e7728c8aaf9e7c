"""The port's tracing (cuadmm_tpu_torch/trace.py): the counter registry as
the chunk runner feeds it, the solve's spans in memory and under the
profiler, layer tracing's segmented recordings, and the set-up's stages.

On the CPU the runner replays its plain version, which launches no graph.
The ``cuda`` test holds layered graphs to whole ones on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_trace.py``.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cuadmm_tpu_torch
from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp

torch.set_num_threads(1)

SOLVE_SPANS = {"solve.start", "solve.chunk", "solve.check", "solve.finish"}
LAYERS = {"layer.algebra", "layer.ell_products", "layer.normal_solve", "layer.projection"}


def _certified():
    return random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)[0]


def _grid(rows=8, cols=12):
    """Max-cut on the 4-neighbour grid graph: mixed block sizes."""
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    return maxcut_chordal((W + W.T).tocsr())[0]


def _solver(prob, device="cpu", **cfg):
    kw = dict(verbose=False, check_every=5, switch_admm=0, normal_solver="precond", projection="jacobi")
    kw.update(cfg)
    return cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(**kw), device=device)


@pytest.fixture(autouse=True)
def tracing_off(monkeypatch):
    """Each test starts with tracing off and no kept record, and leaves
    the module so."""
    monkeypatch.setattr(trace, "_LAST", {})
    trace.disable()
    yield
    trace.disable()


# (switch_admm, iterations): sGS throughout, ADMM throughout, and the
# switch inside the second chunk.
BRANCHES = {"sgs": (10**9, 12), "admm": (0, 12), "switch": (7, 14)}


@pytest.mark.parametrize("case", list(BRANCHES))
def test_counters_of_a_solve_on_the_plain_runner(case):
    """A recording for each branch the solve reaches; every other iteration
    a replay; no graph launched; each sGS iteration two normal solves of
    ``applies`` sweeps, each ADMM iteration one."""
    switch, iters = BRANCHES[case]
    s = _solver(_certified(), switch_admm=switch)
    before = trace.counts()
    res = s.solve(max_iter=iters, stop_tol=0.0)
    delta = {k: v - before[k] for k, v in trace.COUNTS.items()}
    assert res.iterations == iters and s.chunk_runner == "plain"
    n_sgs = min(max(switch - 1, 0), iters)
    branches = (n_sgs > 0) + (n_sgs < iters)
    applies = s.params.neq.applies
    assert delta["graph_captures"] == branches == len(s._runners.runner.recordings)
    assert delta["graph_replays"] == iters - branches
    assert delta["graph_launches"] == 0
    assert delta["neq_sweeps"] == applies * (2 * n_sgs + (iters - n_sgs))
    assert trace.counts() == trace.COUNTS and trace.counts() is not trace.COUNTS


@pytest.mark.parametrize("mode", ["off", "enabled", "profiler"])
def test_spans_of_a_solve(mode):
    """Off: nothing kept. Enabled: ``solve`` holds start, one chunk and
    one check a chunk, and finish, with a host gap between each two
    chunks. Under the CPU profiler each kept span is a record_function
    event of the same name and nesting, its duration within 5% of the kept
    one's, or 50 us beyond the most that record_function's own enter and
    exit add to an empty kept span under the same profiler (tens of us
    on a slow host)."""
    s = _solver(_certified(), switch_admm=7, projection="eigh")  # few ops a step for the profiler
    s.solve(max_iter=15, stop_tol=0.0)  # records both branches
    if mode == "off":
        s.solve(max_iter=15, stop_tol=0.0)
        assert trace.solve_record() is None
        return
    trace.enable()
    if mode == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            empty_us = []
            for _ in range(200):
                t0 = time.perf_counter_ns()
                with trace.span("empty"):
                    pass
                empty_us.append((time.perf_counter_ns() - t0) / 1e3)
            s.solve(max_iter=15, stop_tol=0.0)
    else:
        s.solve(max_iter=15, stop_tol=0.0)
    rec = trace.solve_record()
    spans = sorted(rec["spans"], key=lambda t: t[2])
    children = [n for n, p, _, _ in spans if p == "solve"]
    assert spans[0][:2] == ("solve", None) and set(children) == SOLVE_SPANS
    assert children[0] == "solve.start" and children[-1] == "solve.finish"
    assert children[1:-1] == ["solve.chunk", "solve.check"] * 3
    assert {n for n, p, _, _ in spans if p == "solve.chunk"} == {"layer.algebra"}
    assert {n for n, p, _, _ in spans if p == "layer.algebra"} == LAYERS - {"layer.algebra"}
    assert len(rec["chunk_gaps_ms"]) == 2 and all(g >= 0 for g in rec["chunk_gaps_ms"])
    if mode == "profiler":
        names = {n for n, _, _, _ in spans}
        events = sorted((e for e in prof.events() if e.name in names), key=lambda e: e.time_range.start)
        assert [e.name for e in events] == [n for n, _, _, _ in spans]
        empties = sorted((e for e in prof.events() if e.name == "empty"), key=lambda e: e.time_range.start)
        overhead_us = max(t - e.time_range.elapsed_us() for t, e in zip(empty_us, empties))
        for e, (name, parent, start, end) in zip(events, spans):
            kept_us = (end - start) / 1e3
            assert abs(e.time_range.elapsed_us() - kept_us) <= max(0.05 * kept_us, 50.0 + overhead_us), name
            outer = e.cpu_parent
            while outer is not None and outer.name not in names:
                outer = outer.cpu_parent
            assert (None if outer is None else outer.name) == parent, name


@pytest.mark.parametrize("projection", ["jacobi", "eigh"])
def test_layer_tracing_changes_no_bit(projection):
    """The same solve with layer tracing on and off: X, y, S and the info
    rows bitwise equal; the flag is part of the step's key, so each
    records its own branches."""
    s = _solver(_grid(4, 6), switch_admm=6, projection=projection)
    off = s.solve(max_iter=12, stop_tol=0.0)
    trace.enable(layers=True)
    on = s.solve(max_iter=12, stop_tol=0.0)
    assert s._runners.runner.step.key[-1] is True and s._runners.runner.step.layers
    trace.disable()
    again = s.solve(max_iter=12, stop_tol=0.0)
    assert s._runners.runner.step.key[-1] is False
    for res in (on, again):
        for a, b in ((off.X, res.X), (off.y, res.y), (off.S, res.S)):
            assert np.array_equal(a, b)
        for k in ("pobj", "dobj", "errRp", "errRd", "relgap", "sig"):
            assert np.array_equal(off.info[k], res.info[k]), k


# The keys each mode's init_breakdown had before the build stage: the
# driver's stages, then the normal solver's.
INIT_KEYS = ["structure", "scaling", "ell_tables", "normal_solver"]
NEQ_KEYS = {
    "precond": ["aat", "factorize", "tri_inv", "calibrate"],
    "dense": ["aat", "factorize", "calibrate"],
    "split": ["split_factorize", "calibrate"],
    "cg": ["fsai_build", "fsai_nnz"],
    "host": [],
    "packed": ["packed_factorize", "calibrate"],
    "banded": ["band_factorize", "band_bw", "band_layout", "band_segments", "band_max_segment", "calibrate"],
}


@pytest.mark.parametrize("mode", list(NEQ_KEYS))
def test_init_breakdown_keeps_its_keys_and_gains_the_build(mode):
    """init_breakdown's keys are the stages' as they were, with
    ``neq.build`` (no kernel is built on the CPU: 0); with tracing on, the
    set-up's spans nest init > init.<stage> > neq.<stage>."""
    trace.enable()
    prob = _grid() if mode in ("packed", "banded") else _certified()
    s = _solver(prob, normal_solver=mode)
    keys = INIT_KEYS + ["neq.build"] + [f"neq.{k}" for k in NEQ_KEYS[mode]] + ["params"]
    assert list(s.init_breakdown) == keys and s.init_breakdown["neq.build"] == 0.0
    spans = trace.solve_record("init")["spans"]
    assert [(n, p) for n, p, _, _ in spans if p == "init"] == [(f"init.{k}", "init") for k in INIT_KEYS + ["params"]]
    stages = [k for k in NEQ_KEYS[mode]
              if k not in ("aat", "fsai_nnz", "band_bw", "band_layout", "band_segments", "band_max_segment")]
    assert [n for n, p, _, _ in spans if p == "init.normal_solver"] == [f"neq.{k}" for k in stages]


# ----------------------------------------------------------------------
# On the card: layered graphs against whole ones.
# ----------------------------------------------------------------------


@pytest.mark.cuda
def test_layered_graphs_on_card():
    """Two chunks with layers on and off give bitwise-equal info rows; K1's
    counter per iteration equals the profiler's fused_spd_apply_kernel
    count (which may drop 1-2 events); with layers on, every replay
    launches each graph part of its recording once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    s = _solver(_grid(), device="cuda", check_every=10, switch_admm=10**9)
    rows = {}
    for layers in (False, True):
        if layers:
            trace.enable(layers=True)
        res = s.solve(max_iter=20, stop_tol=0.0)
        rows[layers] = np.stack([res.info[k] for k in ("pobj", "dobj", "errRp", "errRd", "relgap", "sig")])
    assert np.array_equal(rows[False], rows[True])
    rec = next(iter(s._runners.runner.recordings.values()))
    parts = sum(isinstance(p, torch.cuda.CUDAGraph) for p in rec.parts)
    assert s.chunk_runner == "graphs" and rec.tags is not None and parts > 1
    assert set(rec.tags) <= LAYERS
    torch.cuda.synchronize()
    before = trace.counts()
    act = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[act.CPU, act.CUDA]) as prof:
        res = s.solve(max_iter=20, stop_tol=0.0)
        torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in trace.COUNTS.items()}
    k1_events = sum(e.count for e in prof.key_averages() if "fused_spd_apply_kernel" in e.key)
    assert delta["graph_replays"] == res.iterations and delta["graph_captures"] == 0
    assert delta["graph_launches"] == delta["graph_replays"] * parts
    assert delta["k1"] == 2 * s.params.neq.applies * res.iterations
    assert delta["k1"] - 2 <= k1_events <= delta["k1"]
