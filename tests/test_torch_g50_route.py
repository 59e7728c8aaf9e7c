"""G50 (the G-set's 25 x 120 torus through the max-cut pipeline) on the
port's normal path: the route ``auto`` takes for it on an H100, the poly
filter's ``poly_gemm_products`` counter beside ``poly_tri_products``, and
the banded normal solve with a per-bucket projection against the
benchmark's plain reference on a small odd torus.

The route is read from pure functions (``ops/limits.limits_for`` at the
card's memory, ``ops/chol``'s resolution, the committed CUDA sweep
table), so it is pinned here on the CPU: these are the layers the
benchmark's cell ``gset_g50_chordal.sgs`` is meant to measure.
"""

import json
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse.csgraph as csgraph
import torch

from cuadmm_tpu_torch import trace
from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.ops import chol as tchol
from cuadmm_tpu_torch.ops import jacobi as tjacobi
from cuadmm_tpu_torch.ops import limits as lim
from cuadmm_tpu_torch.ops import polyfilter as tpoly
from cuadmm_tpu_torch.ops import projection as tproj
from cuadmm_tpu_torch.ops import svec as tsvec
from cuadmm_tpu_torch.ops import tri_stream as tts
from cuadmm_tpu_torch.solver import driver
from cuadmm_tpu_torch.structure import BlockStructure
from portbench.generators import toroidal_maxcut

REPO = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)

H100_BYTES = 85_017_493_504  # total_memory of an NVIDIA H100 80GB HBM3 (card_fit.py)
G50 = json.loads((REPO / "portbench" / "configs" / "gset_g50_chordal.json").read_text())
G50_BUCKETS = [(8, 1500), (16, 570), (32, 90), (64, 68), (73, 7), (75, 6), (76, 7)]


@pytest.fixture(scope="module")
def g50():
    return toroidal_maxcut.generate(G50["generator_params"], 2**31 + 7)


def _random_sym(b, n, seed):
    m = np.random.default_rng(seed).standard_normal((b, n, n))
    return torch.as_tensor((m + np.swapaxes(m, 1, 2)) / 2)


def test_g50_is_the_configurations_size(g50):
    sizes = G50["sizes"]
    assert (g50.con_num, g50.vec_len, len(g50.At_vals)) == (sizes["con_num"], sizes["vec_len"], sizes["at_nnz"])
    assert dict(Counter(str(n) for _, n in g50.blk)) == sizes["psd_blocks"]


def test_g50_normal_solve_resolves_to_k3s_one_hop_band(g50):
    """Past dense_chol_max and with 118,073 coupled rows (too many for
    split), ``auto`` probes AA^T's RCM bandwidth (4) on an H100 and takes
    the band. Its tile layout would be B 512 by K3's model, nb 272, nbw 1,
    T 544, in the one-hop form (1.14 GB with its derived tiles); but the
    band falls apart into AA^T's 51,653 connected blocks, the longest 30
    rows, and K3's segments form beats that by the card's models, so the
    build takes it and makes no tile."""
    card = lim.limits_for(H100_BYTES)
    a = (g50.At_rows, g50.At_cols, g50.At_vals, g50.con_num, g50.vec_len)
    mode, aat, (bw, perm) = tchol._resolve_auto(*a, torch.float64, True, SolverConfig().dense_chol_max, 1, card)
    assert mode == "banded" and bw == 4 and aat.nnz == 325_922 and sorted(perm) == list(range(g50.con_num))
    assert tchol.past_ceiling_mode(g50.con_num, bw, True, 1, card) == "banded"
    lay = tts.make_band_layout(g50.con_num, bw, model=card.bound_band_model())
    assert (lay.n_pad, lay.block, lay.nb, lay.nbw, lay.T) == (139_264, 512, 272, 1, 544)
    assert tts.band_form(lay, card.band_max_bytes) == "chain"
    assert tts.band_bytes(lay, "two_hop") == 570_425_344 and tts.band_bytes(lay, "chain") == 1_140_850_688
    # K3's fitted model: 272 dependent block steps a sweep, two sweeps.
    assert card.bound_band_model()(lay.T, lay.block, lay.nb) == pytest.approx(0.963e-3, abs=1e-6)
    # The plain reference inverts each connected block of AA^T densely:
    # G50's are all small.
    _, labels = csgraph.connected_components(aat, directed=False)
    assert labels.max() + 1 == 51_653 and np.bincount(labels).max() == 30
    # The band's segments in the RCM order are exactly those blocks.
    pinv = np.empty_like(perm)
    pinv[perm] = np.arange(g50.con_num)
    coo = aat.tocoo()
    lo, hi = np.minimum(pinv[coo.row], pinv[coo.col]), np.maximum(pinv[coo.row], pinv[coo.col])
    bounds = tts.segment_bounds(lo, hi, g50.con_num)
    lens = np.diff(bounds)
    assert len(lens) == 51_653 and lens.max() == 30 and sorted(lens) == sorted(np.bincount(labels))
    tile_s = card.bound_band_model()(lay.T, lay.block, lay.nb)
    assert lim.segment_form(card.segment_model, g50.con_num, bw, 30, tile_s)
    from cuadmm_tpu_torch.ops.sparse import build_sparse_a

    timings = {}
    neq = tchol.build_normal_solver(*a, build_sparse_a(*a, torch.float64, torch.device("cpu")), "banded",
                                    torch.float64, torch.device("cpu"), applies=2, timings=timings, limits=card)
    assert neq.mode == "banded" and isinstance(neq.factor, tchol.SegmentFactor)
    assert (neq.factor.segments.n_segments, neq.factor.segments.max_seg) == (51_653, 30)
    assert (timings["band_bw"], timings["band_segments"], timings["band_max_segment"]) == (4, 51_653, 30)
    assert timings["band_layout"].startswith("form=segments segments=51653 max=30 bytes=")


def test_g50_projection_resolves_to_jacobi_and_the_poly_gemm_route(g50):
    """SolverConfig's buckets (pow2 to 64, exact above) under the committed
    f64 CUDA table: K4 on 8, 16 and 32, the poly filter on 64, 73, 75 and
    76, all batched and below TRI_MIN_N, so its full-GEMM route. (Only
    with every clique padded to a power of two would 73-76 share one 128
    bucket; no caller pads so.)"""
    cfg = SolverConfig()
    st = BlockStructure(g50.blk, cfg.bucket_rounding, cfg.exact_above, 0)
    assert [(bk.n, bk.count) for bk in st.buckets] == G50_BUCKETS
    methods = driver.resolve_projection(cfg, st, torch.device("cuda"))
    assert methods == {0: "jacobi", 1: "jacobi", 2: "jacobi", 3: "poly", 4: "poly", 5: "poly", 6: "poly"}
    for bk in st.buckets[3:]:
        meta = torch.empty((bk.count, bk.n, bk.n), dtype=torch.float64, device="meta")
        assert not tpoly.one_triangle(meta)


def test_g50_k4_buckets_are_k4_shapes(g50):
    """Every bucket the cell sends to K4 is a ``jacobi.K4_SHAPES`` point,
    so the card's checks hold K4 to its plain versions at the cell's own
    shapes."""
    cfg = SolverConfig()
    st = BlockStructure(g50.blk, cfg.bucket_rounding, cfg.exact_above, 0)
    methods = driver.resolve_projection(cfg, st, torch.device("cuda"))
    k4 = [(bk.n, bk.count) for i, bk in enumerate(st.buckets) if methods[i] == "jacobi"]
    assert k4 == [(8, 1500), (16, 570), (32, 90)]
    assert set(k4) <= set(tjacobi.K4_SHAPES)


@pytest.mark.parametrize("dtype,products", [(torch.float64, 40), (torch.float32, 28)])
def test_poly_gemm_products_counts_the_batched_route(dtype, products):
    """A batched bucket makes one GEMM a product (13 steps of three and the
    last in f64, 9 and the last in f32) and no triangle product."""
    x = _random_sym(3, 12, seed=1).to(dtype)
    before = trace.counts()
    tpoly.psd_project_poly(x)
    assert trace.COUNTS["poly_gemm_products"] - before["poly_gemm_products"] == products
    assert trace.COUNTS["poly_tri_products"] == before["poly_tri_products"]


def test_poly_gemm_products_leaves_the_triangle_route_out(monkeypatch):
    """One matrix at n >= TRI_MIN_N takes the triangle route: 40 triangle
    products and no GEMM of the batched route."""
    monkeypatch.setattr(tpoly, "TRI_MIN_N", dict.fromkeys(tpoly.TRI_MIN_N, 8))
    before = trace.counts()
    tpoly.psd_project_poly(_random_sym(1, 12, seed=2))
    assert trace.COUNTS["poly_tri_products"] - before["poly_tri_products"] == 40
    assert trace.COUNTS["poly_gemm_products"] == before["poly_gemm_products"]


def test_poly_gemm_products_counts_each_poly_bucket_of_a_pool():
    """In psd_project_pool under a per-bucket method: 40 GEMMs for each
    bucket on poly, none for the bucket on jacobi."""
    st = BlockStructure([("s", 5)] * 3 + [("s", 12)] * 2 + [("s", 20)] * 2, "pow2", 64, 0)
    maps = tsvec.device_maps(st, torch.float64, torch.device("cpu"))
    pool = tsvec.pool_from_svec(torch.as_tensor(np.random.default_rng(3).standard_normal(st.vec_len)), maps)
    before = trace.counts()
    got = tproj.psd_project_pool(pool, maps, method={0: "jacobi", 1: "poly", 2: "poly"})
    assert trace.COUNTS["poly_gemm_products"] - before["poly_gemm_products"] == 80
    ref = tproj.psd_project_pool(pool, maps, method="eigh")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-10 * float(pool.abs().max()))


def test_banded_solve_with_poly_gemms_follows_the_reference(monkeypatch):
    """The benchmark's entry on a small odd torus (5 x 24: 1,833
    constraints, cliques of 5 to 15, buckets 8 and 16) through G50's route
    on the CPU: ``banded`` (K3's plain path, in the segments form as on
    G50: 729 segments of at most 14 rows), K4's plain
    version on bucket 8 and the poly filter's GEMM route on bucket 16,
    against the plain reference over 200 sGS iterations from the cold
    start. The chunk runner's replays count the filter's GEMMs as the
    eager step does: 40 an iteration."""
    from portbench import compare
    from portbench.entries import sdp_solve
    from portbench.reference.sgs_admm import Reference

    def methods(buckets, backend, dtype):  # poly on the largest bucket, K4 below it
        top = max(range(len(buckets)), key=lambda i: buckets[i][0])
        return {i: "poly" if i == top else "jacobi" for i in range(len(buckets))}

    monkeypatch.setattr(driver, "choose_methods", methods)
    prob = toroidal_maxcut.generate(dict(rows=5, cols=24), 2**31 + 5)
    settings = dict(G50["solver"], dtype="float64", normal_solver="banded")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = Reference(prob, settings, "cpu").solve(200, 0.0)
    program = sdp_solve.build(prob, settings, "cpu")
    facts = program.facts()
    assert facts["normal_solver"] == "banded" and facts["projection"] == {0: "jacobi", 1: "poly"}
    assert "form=segments segments=729 max=14" in program.init_breakdown["neq.band_layout"]
    before = trace.counts()
    res = program.solve(200, 0.0)
    assert trace.COUNTS["poly_gemm_products"] - before["poly_gemm_products"] == 40 * 200
    assert trace.COUNTS["poly_tri_products"] == before["poly_tri_products"]
    assert res["failure"] is None and ref["iterations"] == res["iterations"] == 200
    gaps = compare.gaps(res, ref)
    # K3's f32 band factor is refined to a 1e-10 relative residual in f64
    # (the calibrated sweeps); the filter's sign error is below 3e-15 for
    # eigenvalues of 1e-6 of the scale; the reference solves directly with
    # eigh. Both read about 1e-11 here.
    assert gaps["iterate_gap"] < 1e-8 and gaps["info_gap"] < 1e-8, gaps


@pytest.mark.parametrize("rows,cols", [(5, 24), (7, 10)])
def test_segments_form_follows_the_tile_forms_info_rows(monkeypatch, rows, cols):
    """A banded sGS solve (stop_tol 0, 60 iterations, the switch to ADMM at
    30) in K3's segments form against the same solve with the segments
    form off (``limits.SEGMENT_MODEL`` None: the tile forms, as before it
    existed): every info row within 1e-9, relative. Both factors are the
    same regularized AA^T rounded to f32, refined to 1e-10 in f64."""
    from portbench.entries import sdp_solve

    prob = toroidal_maxcut.generate(dict(rows=rows, cols=cols), 2**31 + 5)
    settings = dict(G50["solver"], dtype="float64", normal_solver="banded", switch_admm=30)
    info = {}
    for form in ("segments", "tile"):
        if form == "tile":
            monkeypatch.setattr(lim, "SEGMENT_MODEL", None)
        program = sdp_solve.build(prob, settings, "cpu")
        assert isinstance(program.solver.params.neq.factor, tchol.SegmentFactor) == (form == "segments")
        res = program.solve(60, 0.0)
        assert res["failure"] is None and res["iterations"] == 60
        info[form] = res["info"]
    np.testing.assert_allclose(info["segments"], info["tile"], rtol=1e-9, atol=0)
