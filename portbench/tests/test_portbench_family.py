"""The +-J family of G11's torus: the generator's sizes and seeds, its
agreement with the program's own front end, the batched entry against the
family's reference on a tiny grid, and the batch's three readers."""

from __future__ import annotations

import importlib.util
import json
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from portbench_tiny import REPO

sys.path.insert(0, str(REPO))

from portbench import compare, program_trace  # noqa: E402
from portbench.generators import toroidal_maxcut, toroidal_maxcut_family  # noqa: E402
from portbench.reference.sgs_admm_family import Reference  # noqa: E402

CELL = "gset_g11_weighted.family8"
CONFIG = json.loads((REPO / "portbench" / "configs" / "gset_g11_weighted.json").read_text())
WORKLOAD = json.loads((REPO / "portbench" / "workloads" / f"{CELL}.json").read_text())
SHARED = ("At_rows", "At_cols", "At_vals", "b_indices", "b_vals")
READERS = ("batch.k1_rhs_per_launch", "batch.eigh_waits_per_it", "batch.host_ms_per_solve")
TINY = dict(rows=6, cols=4, instances=3)


def _reader(name):
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"),
                                                  REPO / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_g11_family_sizes_and_what_the_seed_changes():
    a = toroidal_maxcut_family.generate(CONFIG["generator_params"], 2**31 + 3)
    b = toroidal_maxcut_family.generate(CONFIG["generator_params"], 7)
    sizes = CONFIG["sizes"]
    assert (a.con_num, a.vec_len, len(a.At_vals)) == (sizes["con_num"], sizes["vec_len"], sizes["at_nnz"]) == (
        18_692, 26_225, 36_584)
    counts = {}
    for kind, n in a.blk:
        counts[str(n)] = counts.get(str(n), 0) + 1
    assert counts == sizes["psd_blocks"] and len(a.blk) == 598
    assert len(a.objectives) == sizes["instances"] == 8
    # A is G11's (gset_g11_chordal's) in every instance and under every seed.
    g11 = toroidal_maxcut.generate(dict(rows=100, cols=8), 0)
    for i in range(8):
        for f in SHARED:
            assert np.array_equal(getattr(a.instance(i), f), getattr(g11, f)), f
            assert np.array_equal(getattr(b.instance(i), f), getattr(g11, f)), f
    assert a.blk == b.blk == g11.blk
    dense = lambda p, i: p.instance(i).dense_C()
    assert all(not np.array_equal(dense(a, i), dense(b, i)) for i in range(8))  # the seed changes C
    assert all(not np.array_equal(dense(a, 0), dense(a, i)) for i in range(1, 8))  # so does the instance
    again = toroidal_maxcut_family.generate(CONFIG["generator_params"], 2**31 + 3)
    assert all(np.array_equal(dense(a, i), dense(again, i)) for i in range(8))


def test_the_weights_are_plus_minus_one_on_every_edge():
    G = toroidal_maxcut.toroidal_grid(6, 4)
    Ws = toroidal_maxcut_family.signed_weights(G, 5, 2**31 + 9)
    for W in Ws:
        assert (W != W.T).nnz == 0 and set(np.abs(W.data)) == {1.0}
        assert np.array_equal((abs(W) != 0).toarray(), (G != 0).toarray())
    signs = np.concatenate([W.data for W in Ws])
    assert 0.3 < np.mean(signs > 0) < 0.7


def test_the_family_is_the_programs_signed_front_end():
    from cuadmm_tpu_torch.models.chordal import maxcut_chordal_family

    fam = toroidal_maxcut_family.generate(TINY, 2**31 + 5)
    Ws = toroidal_maxcut_family.signed_weights(toroidal_maxcut.toroidal_grid(6, 4), 3, 2**31 + 5)
    probs, _ = maxcut_chordal_family(Ws, signed=True)
    for i, want in enumerate(probs):
        got = fam.instance(i)
        assert got.blk == want.blk and got.con_num == want.con_num
        for f in SHARED + ("C_indices", "C_vals"):
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and np.array_equal(g, w), (i, f)


def _program(check_every=5, **solver):
    import torch

    from portbench.entries import batched_solve

    prob = toroidal_maxcut_family.generate(TINY, 2**31 + 5)
    settings = dict(CONFIG["solver"], check_every=check_every, dtype="float64", **solver)
    return prob, settings, batched_solve.build(prob, settings, torch.device("cpu"))


def test_the_entry_and_the_reference_agree_within_the_cells_limits():
    prob, settings, program = _program(check_every=25)
    res = program.solve(100, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = Reference(prob, settings, "cpu").solve(100, 0.0)
    assert res["failure"] is None and res["iterations"] == ref["iterations"] == 3 * 100
    assert res["info"].shape == ref["info"].shape == (300, 8)
    assert res["X"].shape == ref["X"].shape == (3 * prob.vec_len,)
    assert res["y"].shape == ref["y"].shape == (3 * prob.con_num,)
    gaps = compare.gaps(res, ref)
    assert all(gaps[k] < WORKLOAD["limits"][k] / 100 for k in WORKLOAD["limits"]), gaps
    facts = program.facts()
    assert facts["instances"] == 3 and facts["chunk_runner"] == "plain" and isinstance(facts["projection"], dict)


def test_a_changed_instance_reads_not_correct():
    prob, settings, program = _program(check_every=25)
    res = program.solve(100, 0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = Reference(prob, settings, "cpu").solve(100, 0.0)
    pos, vals = prob.objectives[2]
    prob.objectives[2] = (pos, vals * 1.01)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        other = Reference(prob, settings, "cpu").solve(100, 0.0)
    limits = WORKLOAD["limits"]
    assert all(v["value"] <= v["limit"] for v in compare.judge([res], ref, limits).values())
    assert not all(v["value"] <= v["limit"] for v in compare.judge([res], other, limits).values())


def test_the_manifest_scopes_the_readers_to_the_cell():
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == [CELL] and entries[name]["moves"] == "it_per_s"
    cell = next(w for w in man["workloads"] if w["name"] == CELL)
    assert cell["config"] == "gset_g11_weighted" and cell["chips"] == 1
    assert WORKLOAD["entry"] == "batched_solve" and WORKLOAD["max_iter"] == 500 and WORKLOAD["dtype"] == "float64"


def test_the_readers_on_the_tiny_family_on_the_cpu(monkeypatch):
    """No K1 runs on the CPU, so its share reads nothing; the CPU table
    puts the tiny buckets on eigh, whose segments the plain replay counts
    (one a bucket and batch iteration); the start and finish spans read.
    A program without the counters or the trace module gives None."""
    from cuadmm_tpu_torch import trace
    from cuadmm_tpu_torch.ops.dispatch import bucket_method

    _, _, program = _program()
    program.solve(5, 0.0)
    ctx = SimpleNamespace(program=program, workload=dict(max_iter=20), stop_tol=0.0, sync=lambda: None)
    got = {m: _reader(m).read(ctx) for m in READERS}
    structure = program.solver._base.structure
    eigh_buckets = sum(bucket_method(program.solver._projection, i) == "eigh" and bk.n > 1
                       for i, bk in enumerate(structure.buckets))
    assert got["batch.k1_rhs_per_launch"] is None
    assert got["batch.eigh_waits_per_it"] == pytest.approx(eigh_buckets / 3)
    assert got["batch.host_ms_per_solve"] > 0
    assert not trace._RECORDING  # left off

    # An older program: no batch spans, neither counter (its projection
    # here runs no eigh segment, which would count one), or no trace module.
    _, _, older = _program(projection="jacobi")
    monkeypatch.setattr(trace, "COUNTS", {k: v for k, v in trace.COUNTS.items()
                                          if k not in ("k1_rhs", "eigh_waits")})
    monkeypatch.setattr(trace, "solve_record", lambda root="solve": None)
    bare = SimpleNamespace(**dict(vars(ctx), program=older))
    del bare.batch_trace
    assert all(_reader(m).read(bare) is None for m in READERS)
    monkeypatch.setattr(program_trace, "_program_trace", lambda: None)
    del bare.batch_trace
    assert all(_reader(m).read(bare) is None for m in READERS)
