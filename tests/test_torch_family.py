"""Signed max-cut in the port's front end, the +-J family built from one
clique tree, and BatchedSDPSolver on it: the calibrated projection at the
batch's own bucket sizes, the family's plain reference, the ``batch``
spans and the ``k1_rhs`` and ``eigh_waits`` counters.

The card-only check at the end runs with ``--noconftest`` on a machine
without jax.
"""

import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cuadmm_tpu_torch
from cuadmm_tpu_torch import BatchedSDPSolver, trace
from cuadmm_tpu_torch.models.chordal import maxcut_chordal, maxcut_chordal_family
from cuadmm_tpu_torch.ops import dispatch
from cuadmm_tpu_torch.parallel.batch import _same_pattern

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

CFG = dict(verbose=False, check_every=25)
FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig")


def _torus(rows, cols):
    """The rows x cols toroidal grid's 0/1 adjacency (rudy's numbering)."""
    node = np.arange(rows * cols).reshape(rows, cols)
    src = np.concatenate([node.ravel(), node.ravel()])
    dst = np.concatenate([np.roll(node, -1, axis=1).ravel(), np.roll(node, -1, axis=0).ravel()])
    W = sp.coo_matrix((np.ones(src.size), (src, dst)), shape=(node.size, node.size)).tocsr()
    return (W + W.T).tocsr()


def _pm_j(G, seed):
    """G's edges weighted +1 or -1 with equal odds."""
    up = sp.triu(G, 1).tocoo()
    signs = np.random.default_rng(seed).choice([-1.0, 1.0], up.nnz)
    W = sp.coo_matrix((signs, (up.row, up.col)), shape=G.shape).tocsr()
    return (W + W.T).tocsr()


def _family(n, rows=6, cols=4):
    G = _torus(rows, cols)
    return maxcut_chordal_family([_pm_j(G, seed) for seed in range(n)], signed=True)


def _dense_maxcut(W):
    """The signed max-cut SDP written out by hand: min <C, X>, diag(X) = 1,
    X PSD, C = -(1/4) (Diag(W e) - W)."""
    Wd = W.toarray()
    n = Wd.shape[0]
    C = -0.25 * (np.diag(Wd.sum(axis=1)) - Wd)
    r, c = np.tril_indices(n)
    svec = lambda M: M[r, c] * np.where(r == c, 1.0, np.sqrt(2.0))
    A = np.stack([svec(np.diag(np.eye(n)[i])) for i in range(n)])
    return cuadmm_tpu_torch.Problem.from_dense([("s", n)], A, np.ones(n), svec(C)), C


def _clique_blocks(prob, info, X):
    """X's principal submatrices on the cliques, as the chordal problem's
    svec vector."""
    out = np.zeros(prob.vec_len)
    for u, cl in enumerate(info.tree.clique):
        r, c = np.tril_indices(len(cl))
        out[info.block_offsets[u] + r * (r + 1) // 2 + c] = X[cl[r], cl[c]] * np.where(r == c, 1.0, np.sqrt(2.0))
    return out


def test_signed_maxcut_is_the_dense_signed_sdp():
    """On a +-J 6x4 torus: the chordal problem's objective at any X is
    <C, X> of the signed Laplacian's C, X's clique blocks meet its
    constraints, and its optimum is the dense SDP's."""
    W = _pm_j(_torus(6, 4), 3)
    prob, info = maxcut_chordal(W, signed=True)
    dense, C = _dense_maxcut(W)
    rng = np.random.default_rng(0)
    V = rng.standard_normal((24, 5))
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    X = V @ V.T  # PSD, unit diagonal
    x = _clique_blocks(prob, info, X)
    assert prob.dense_C() @ x == pytest.approx(np.sum(C * X), rel=1e-12)
    A = sp.csr_matrix((prob.At_vals, (prob.At_cols, prob.At_rows)), shape=(prob.con_num, prob.vec_len))
    np.testing.assert_allclose(A @ x, prob.dense_b(), rtol=0, atol=1e-12)
    cfg = cuadmm_tpu_torch.SolverConfig(projection="eigh", **CFG)
    got = cuadmm_tpu_torch.SDPSolver(prob, cfg, device="cpu").solve(max_iter=20000, stop_tol=1e-7)
    want = cuadmm_tpu_torch.SDPSolver(dense, cfg, device="cpu").solve(max_iter=20000, stop_tol=1e-7)
    assert got.converged and want.converged
    assert got.pobj == pytest.approx(want.pobj, rel=1e-5)
    # |W| would solve another problem: the bipartite torus' all-edges cut.
    unsigned, _ = maxcut_chordal(W)
    assert not np.array_equal(unsigned.dense_C(), prob.dense_C())


def test_the_default_is_still_the_absolute_weights():
    W = _pm_j(_torus(6, 4), 4)
    got, _ = maxcut_chordal(W)
    for want, _ in (maxcut_chordal(abs(W)), maxcut_chordal(W, signed=False)):
        assert got.blk == want.blk and got.con_num == want.con_num
        for f in ("At_rows", "At_cols", "At_vals", "b_indices", "b_vals", "C_indices", "C_vals"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_the_family_shares_blk_and_a_and_differs_in_c():
    probs, _ = _family(4)
    G = _torus(6, 4)
    for i, p in enumerate(probs):
        assert p.blk == probs[0].blk and _same_pattern(probs[0], p)
        assert all(np.array_equal(getattr(p, f), getattr(probs[0], f)) for f in ("At_rows", "At_cols", "At_vals"))
        own, _ = maxcut_chordal(_pm_j(G, i), signed=True)  # as if converted alone
        assert np.array_equal(p.C_indices, own.C_indices) and np.array_equal(p.C_vals, own.C_vals)
        if i:
            assert not np.array_equal(p.dense_C(), probs[0].dense_C())
    other = _pm_j(_torus(4, 6), 1)
    with pytest.raises(ValueError, match="pattern"):
        maxcut_chordal_family([_pm_j(G, 0), other], signed=True)
    cut = _pm_j(G, 2).tolil()
    cut[0, 1] = cut[1, 0] = 0.0
    with pytest.raises(ValueError, match="pattern"):
        maxcut_chordal_family([_pm_j(G, 0), cut.tocsr()], signed=True)
    with pytest.raises(ValueError):
        maxcut_chordal_family([])


def _table(rows):
    """``dispatch.load_sweep`` reading ``rows`` for every backend."""
    return lambda backend, dtype_name: [dict(r, dtype=dtype_name) for r in rows]


# At n = 8, eigh wins at 8 blocks and jacobi at 64: one instance of the
# 4x4 family (one bucket, 8 x 10) takes eigh, a batch of three (8 x 30)
# jacobi. (Jacobi's plain version on the CPU is slow past n = 8.)
BY_COUNT = [dict(n=8, batch=8, eigh_ms=1.0, poly_ms=3.0, jacobi_ms=2.0),
            dict(n=8, batch=64, eigh_ms=3.0, poly_ms=4.0, jacobi_ms=1.0)]


@pytest.mark.parametrize("projection", ["jacobi", "auto"])
def test_batch_equals_single_solves_with_the_same_methods(projection, monkeypatch):
    """A batch of three +-J instances equals each instance's own SDPSolver
    solve with the batch's per-bucket methods (1e-9). Under "auto" the
    batch resolves at its own bucket sizes (blocks times instances), where
    a single solve resolves another way, and runs no eigh segment."""
    if projection == "auto":
        monkeypatch.setattr(dispatch, "load_sweep", _table(BY_COUNT))
    probs, _ = _family(3, 4, 4)
    cfg = cuadmm_tpu_torch.SolverConfig(projection=projection, **CFG)
    batch = BatchedSDPSolver(probs, cfg, device="cpu")
    if projection == "auto":
        assert batch._projection == {0: "jacobi"} and batch._base._projection == {0: "eigh"}
    else:
        assert batch._projection == "jacobi"
    trace.reset()
    res = batch.solve(max_iter=50, stop_tol=0.0)
    assert trace.COUNTS["eigh_waits"] == 0 and batch.chunk_runner == "plain"
    for p, rb in zip(probs, res):
        single = cuadmm_tpu_torch.SDPSolver(p, cfg, device="cpu")
        single._projection = batch._projection
        rs = single.solve(max_iter=50, stop_tol=0.0)
        assert rb.iterations == rs.iterations == 50
        for f in FIELDS:
            np.testing.assert_allclose(rb.info[f], rs.info[f], rtol=1e-9, atol=0, err_msg=f)
        np.testing.assert_allclose(rb.X, rs.X, rtol=0, atol=1e-9 * (1 + np.abs(rs.X).max()))


def test_auto_resolves_from_the_batchs_counts_with_the_committed_table():
    probs, _ = _family(3)
    batch = BatchedSDPSolver(probs, cuadmm_tpu_torch.SolverConfig(**CFG), device="cpu")
    buckets = batch._base.structure.buckets
    assert batch._projection == dispatch.choose_methods([(bk.n, 3 * bk.count) for bk in buckets], "cpu", "float64")
    ranked = BatchedSDPSolver(probs, cuadmm_tpu_torch.SolverConfig(eig_rank=2, **CFG), device="cpu")
    assert ranked._projection == "eigh"


def test_eigh_segments_are_counted_once_a_bucket_and_iteration():
    probs, _ = _family(3)
    batch = BatchedSDPSolver(probs, cuadmm_tpu_torch.SolverConfig(projection="eigh", **CFG), device="cpu")
    batch.solve(max_iter=25, stop_tol=0.0)  # records the branch
    trace.reset()
    batch.solve(max_iter=50, stop_tol=0.0)
    eigh_buckets = sum(bk.n > 1 for bk in batch._base.structure.buckets)
    assert eigh_buckets and trace.COUNTS["eigh_waits"] == eigh_buckets * 50


def test_batch_matches_the_familys_reference():
    """The batch against portbench's plain f64 reference of the family
    (AA^T factored once, each instance from its own cold start), within
    the cell's limits."""
    sys.path.insert(0, str(REPO))
    import json

    from portbench import compare
    from portbench.generators.toroidal_maxcut_family import FamilyArrays
    from portbench.problem import ProblemArrays
    from portbench.reference.sgs_admm_family import Reference

    root = REPO / "portbench"
    settings = json.loads((root / "configs" / "gset_g11_weighted.json").read_text())["solver"]
    limits = json.loads((root / "workloads" / "gset_g11_weighted.family8.json").read_text())["limits"]
    probs, _ = _family(3)
    shared = {f.name: getattr(probs[0], f.name) for f in dataclasses.fields(ProblemArrays)}
    fam = FamilyArrays(**shared, objectives=[(p.C_indices, p.C_vals) for p in probs])
    settings = dict(settings, check_every=25)
    res = BatchedSDPSolver(probs, cuadmm_tpu_torch.SolverConfig(verbose=False, **settings), device="cpu").solve(
        max_iter=150, stop_tol=0.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = Reference(fam, dict(settings, dtype="float64"), "cpu").solve(150, 0.0)
    got = dict(X=np.concatenate([r.X for r in res]), y=np.concatenate([r.y for r in res]),
               S=np.concatenate([r.S for r in res]), iterations=sum(r.iterations for r in res),
               info=np.concatenate([np.stack([r.info[f] for f in FIELDS + ("bscale", "Cscale")], axis=1)
                                    for r in res]))
    gaps = compare.gaps(got, ref)
    assert all(gaps[k] <= limits[k] for k in limits), gaps


def test_batch_spans_and_chunk_edges():
    probs, _ = _family(3)
    batch = BatchedSDPSolver(probs, cuadmm_tpu_torch.SolverConfig(projection="eigh", **CFG), device="cpu")
    try:
        trace.enable()
        batch.solve(max_iter=75, stop_tol=0.0)
        rec = trace.solve_record("batch")
        trace.enable(layers=True)
        batch.solve(max_iter=25, stop_tol=0.0)
        layered = trace.solve_record("batch")
    finally:
        trace.disable()
    names = [n for n, _, _, _ in rec["spans"]]
    parents = {n: p for n, p, _, _ in rec["spans"]}
    assert names.count("batch") == 1 and names[-1] == "batch"
    assert names.count("batch.start") == names.count("batch.finish") == 1
    assert names.count("batch.chunk") == names.count("batch.check") == 3
    assert all(parents[n] == "batch" for n in ("batch.start", "batch.chunk", "batch.check", "batch.finish"))
    assert len(rec["chunk_gaps_ms"]) == 2 and all(g >= 0 for g in rec["chunk_gaps_ms"])
    for n, p, s, e in rec["spans"]:
        assert e >= s
    # The step's layers run inside the batch's chunks, with the instance axis.
    layer_names = {n for n, _, _, _ in layered["spans"] if n.startswith("layer.")}
    assert layer_names == {"layer.algebra", "layer.ell_products", "layer.normal_solve", "layer.projection"}


def test_k1_counts_its_right_hand_sides_on_the_cpu_nowhere():
    """K1's plain version on the CPU counts neither launches nor
    right-hand sides."""
    probs, _ = _family(2)
    batch = BatchedSDPSolver(probs, cuadmm_tpu_torch.SolverConfig(normal_solver="precond", **CFG), device="cpu")
    trace.reset()
    batch.solve(max_iter=25, stop_tol=0.0)
    assert trace.COUNTS["k1"] == trace.COUNTS["k1_rhs"] == 0 and trace.COUNTS["neq_sweeps"] > 0


@pytest.mark.cuda
def test_family_on_card_auto_k1_rhs_and_layer_cut_graphs():
    """On the card: under "auto" the batch runs one graph an iteration with
    no eigh segment; K1 runs once a sweep and serves the eight instances'
    right-hand sides in that one launch (K1 over B); the graphs cut at each
    layer boundary give the same results bit for bit; under "eigh" each
    eigh bucket is one segment an iteration."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K4 have no CPU or interpret mode")
    probs, _ = _family(8, 10, 8)
    cfg = cuadmm_tpu_torch.SolverConfig(normal_solver="precond", check_every=10, verbose=False)
    batch = BatchedSDPSolver(probs, cfg)
    assert all(m != "eigh" for m in batch._projection.values())
    batch.solve(max_iter=10, stop_tol=0.0)
    torch.cuda.synchronize()
    trace.reset()
    plain = batch.solve(max_iter=20, stop_tol=0.0)
    torch.cuda.synchronize()
    applies = batch.params.neq.applies
    assert batch.chunk_runner == "graphs" and trace.COUNTS["eigh_waits"] == 0
    assert trace.COUNTS["k1"] == 20 * 2 * applies
    assert trace.COUNTS["k1_rhs"] == 8 * trace.COUNTS["k1"]
    assert trace.COUNTS["graph_launches"] == trace.COUNTS["graph_replays"]
    try:
        trace.enable(layers=True)
        cut = batch.solve(max_iter=20, stop_tol=0.0)
    finally:
        trace.disable()
    for a, b in zip(plain, cut):
        assert np.array_equal(a.X, b.X) and np.array_equal(a.info["errRp"], b.info["errRp"])
    eigh = BatchedSDPSolver(probs, cfg.replace(projection="eigh"))
    eigh.solve(max_iter=10, stop_tol=0.0)
    torch.cuda.synchronize()
    trace.reset()
    eigh.solve(max_iter=20, stop_tol=0.0)
    eigh_buckets = sum(bk.n > 1 for bk in eigh._base.structure.buckets)
    assert trace.COUNTS["eigh_waits"] == eigh_buckets * 20
