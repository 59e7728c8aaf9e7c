"""Measure the card's inputs to ops/limits.py and fit them.

    python -m cuadmm_tpu_torch.card_fit

On the first CUDA device:

- each factor mode's build peak: ``torch.cuda.max_memory_allocated()``
  over one ``build_normal_solver`` call, less what was allocated before it
  (A's f64 tables), for packed on the 20x60 and 20x120 grid max-cuts,
  banded on the same two grids, precond on the 20x60 and 20x80 grids
  (dense_chol_max raised to take them), and ``band_cholesky`` on a
  synthetic PushBox N=30 band (n 154,256, bandwidth 20,512; its tiles made
  on the card, counted from before they are allocated);
- K3's solve time (CUDA events, synthetic factors) at B in
  (1024, 512, 256) on four bands: the 20x120 grid's, pendulum N=80's,
  PushBox N=30's and a mid band;
- K3's segments form (replayed CUDA graphs): synthetic segment bands of
  G50's rows in segments of 1 to 512 rows at bandwidth 4 and 16;

then fits each mode's peak line (``fit_peak``), K3's band model
(``fit_band_model``; ops/limits.py says why its form) and the segments
form's (``fit_segment_model``), and prints the card line and one JSON line, also
written to chiprun_out/card_fit.json. ``chip_smoke.py``'s ``limits``
phase runs the same measurements each time and holds them to the
committed fit. The banded builds are pinned to K3's tile forms
(``tile_forms``): the peak line bounds the tiles, which the segments
form never makes.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
from scipy.optimize import nnls
import torch

from cuadmm_tpu_torch.device import card_line, resolve_device
from cuadmm_tpu_torch.k4_ab import graph_ms
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.ops import limits as lim
from cuadmm_tpu_torch.ops import tri_stream
from cuadmm_tpu_torch.ops.chol import build_normal_solver, chain_tiles
from cuadmm_tpu_torch.ops.sparse import build_sparse_a, normalize_rows

# (label, n, bandwidth): the 20x120 grid's under RCM, pendulum N=80's and
# PushBox N=30's (cuadmm_tpu/ops/chol.py:104-109), and one between them.
BANDS = (("grid 20x120", 68350, 4), ("mid", 100000, 5000),
         ("pendulum N=80", 112028, 1615), ("PushBox N=30", 154256, 20512))
BLOCKS = (1024, 512, 256)
PUSHBOX = BANDS[3]
K3_REPS, K3_ROUNDS = 5, 3
# Two blocks whose solve times differ by less than this are a tie: the
# 20x120 grid's band ran B 1024 and 512 at 0.908 and 0.903 ms in one
# measurement and 0.916 and 0.930 in the next (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md, PR 11).
K3_TIE = 0.03
# (mode, grid shape): the builds whose peaks each mode's line is fitted to.
PEAK_BUILDS = (("packed", (20, 60)), ("packed", (20, 120)), ("banded", (20, 60)),
               ("banded", (20, 120)), ("precond", (20, 60)), ("precond", (20, 80)))
REPORT = Path("chiprun_out") / "card_fit.json"
# K3's segments form: bands of G50's rows in segments of each length, at
# each bandwidth (limits.SEGMENT_MODEL).
SEG_N = 139192
SEG_LENGTHS = (1, 8, 30, 64, 128, 256, 512)
SEG_BWS = (4, 16)
SEG_REPS = 200


def tile_forms(device: torch.device) -> lim.CardLimits:
    """The card's limits with K3's segments form off: a banded build takes
    the tile forms whose peaks and solve times this module fits."""
    return dataclasses.replace(lim.card_limits(device), segment_model=None)


def grid_problem(shape):
    """The max-cut SDP of the 4-neighbour rows x cols grid graph, chordally
    decomposed (models/chordal.py)."""
    rows, cols = shape
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    return maxcut_chordal((W + W.T).tocsr())[0]


def _factor_bytes(neq) -> int:
    """The factor's f32 bytes: precond's padded square, else its tiles (a
    band's derived tiles included, ``tri_stream.band_bytes``)."""
    f = neq.factor
    if neq.mode == "precond":
        return f.inv_l.numel() * 4
    if neq.mode == "banded":
        return tri_stream.band_bytes(f.layout, f.form)
    return f.layout.T * f.layout.block * f.layout.block * 4


def build_peak(prob, mode: str, device: torch.device) -> dict:
    """One ``build_normal_solver`` call in ``mode`` on ``prob`` (f64 state,
    calibrated sweeps): its factor's bytes, the device memory its build
    peaked at beyond what was allocated before it, its timings."""
    _, vals = normalize_rows(prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num)
    args = (prob.At_rows, prob.At_cols, vals, prob.con_num, prob.vec_len)
    sa = build_sparse_a(*args, torch.float64, device)
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    timings: dict = {}
    t0 = time.perf_counter()
    neq = build_normal_solver(*args, sa, mode, torch.float64, device, applies=0, timings=timings,
                              dense_chol_max=max(32768, prob.con_num), limits=tile_forms(device))
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    out = dict(mode=mode, con_num=prob.con_num, vec_len=prob.vec_len, factor_bytes=_factor_bytes(neq),
               peak_bytes=torch.cuda.max_memory_allocated(device) - base, seconds=seconds, timings=timings,
               applies=neq.applies)
    del neq, sa
    torch.cuda.empty_cache()
    return out


def _synthetic_band(lay, seed: int, diag: float) -> torch.Tensor:
    """Band tiles on the card, made in place: off-diagonal tiles N(0,
    1/(B nbw)), diagonal tiles ``diag`` I plus a tenth of that noise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = lay.block
    tiles = torch.empty((lay.T + 1, B, B), device="cuda").normal_(generator=gen)
    tiles.mul_(1.0 / (B * max(lay.nbw, 1)) ** 0.5)
    eye = torch.eye(B, device="cuda")
    for k in range(lay.nb):
        tiles[tri_stream.tid_band(k, k, lay)].mul_(0.1).add_(eye, alpha=diag)
    return tiles


def synthetic_band_peak(n: int, bw: int) -> dict:
    """``band_cholesky`` on a synthetic SPD band of ``n`` rows and
    bandwidth ``bw`` (the card's block), then its derived tiles where the
    band takes the one-hop form: the bytes held and the peak counted from
    before the tiles were allocated."""
    lay = tri_stream.make_band_layout(n, bw)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tiles = _synthetic_band(lay, seed=7, diag=10.0)  # eigenvalues >= ~7: the off-band part's norm is ~2.8
    status = tri_stream.band_cholesky(tiles, lay)
    ok = bool((status == 0) & torch.isfinite(tiles[tri_stream.tid_band(lay.nb - 1, lay.nb - 1, lay), -1, -1]))
    form, chain = chain_tiles(tiles, lay)
    torch.cuda.synchronize()
    out = dict(mode="banded", n=n, bw=bw, layout=lay._asdict(), factor_bytes=tri_stream.band_bytes(lay, form),
               peak_bytes=torch.cuda.max_memory_allocated() - base, seconds=time.perf_counter() - t0,
               factored=ok)
    del tiles, chain
    torch.cuda.empty_cache()
    return out


def _time_ms(fn, reps: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def k3_times(bands=BANDS, blocks=BLOCKS) -> list:
    """K3's solve time at each block of ``blocks`` on each band, in the form
    the solver runs there (the one-hop form's derived tiles formed first):
    synthetic factors (diagonal tiles near the identity) of every block at once, three
    warm solves each, then K3_ROUNDS rounds of K3_REPS solves taking the
    blocks in turns; the least round. The sweep tables and scratch of
    layouts made here are dropped after each band (tri_stream keeps them
    per layout)."""
    rows = []
    for i, (label, n, bw) in enumerate(bands):
        kept = set(tri_stream._STEPS)
        r = torch.randn(n, device="cuda", generator=torch.Generator(device="cuda").manual_seed(i))
        runs = []
        for B in blocks:
            lay = tri_stream.make_band_layout(n, bw, block=B)
            tiles = _synthetic_band(lay, seed=100 + i, diag=1.0)
            form, chain = chain_tiles(tiles, lay)
            runs.append((lay, tiles, lambda lay=lay, tiles=tiles, chain=chain, form=form: tri_stream.band_solve(
                tiles, r, lay, chain=chain, form=form)))
        for _, _, solve in runs:
            for _ in range(3):
                solve()
        ms = [min(t) for t in zip(*[[_time_ms(solve, K3_REPS) for _, _, solve in runs] for _ in range(K3_ROUNDS)])]
        for (lay, _, _), t in zip(runs, ms):
            rows.append(dict(band=label, n=n, bw=bw, B=lay.block, nb=lay.nb, nbw=lay.nbw, T=lay.T,
                             gb=lay.T * lay.block**2 * 4 / 1e9, ms=t))
        del runs, r
        for key in set(tri_stream._STEPS) - kept:
            del tri_stream._STEPS[key]
        torch.cuda.empty_cache()
    return rows


def synthetic_segments(n: int, m: int, bw: int, seed: int, device=None) -> tri_stream.SegmentBand:
    """K3's segments form of a diagonally dominant SPD band of ``n`` rows in
    segments of ``m`` rows (the last shorter), bandwidth ``bw`` (off-band
    entries N(0, 1), each diagonal 1 + its row's absolute sum), its solver
    rows shuffled, built as the solver builds it (``segment_band``)."""
    rng = np.random.default_rng(seed)
    bounds = np.r_[np.arange(0, n, m), n]
    seg = np.repeat(np.arange(len(bounds) - 1), np.diff(bounds))
    lo, hi = [], []
    for k in range(1, bw + 1):
        i = np.flatnonzero(seg[k:] == seg[:-k])
        lo.append(i)
        hi.append(i + k)
    lo, hi = np.concatenate(lo), np.concatenate(hi)
    off = rng.standard_normal(len(lo))
    diag = 1.0 + np.bincount(lo, np.abs(off), n) + np.bincount(hi, np.abs(off), n)
    rows = np.concatenate([lo, hi, np.arange(n)])
    cols = np.concatenate([hi, lo, np.arange(n)])
    vals = np.concatenate([off, off, diag])
    band, ok = tri_stream.segment_band(rows, cols, vals, bounds, bw, rng.permutation(n), 1e-7, 1.0, device)
    assert ok, "a diagonally dominant band factors"
    return band


def segment_times(n: int = SEG_N, lengths=SEG_LENGTHS, bws=SEG_BWS) -> list:
    """The segments form's solve time (one launch, forward and backward, f64
    r) on ``synthetic_segments`` at each length and bandwidth: SEG_REPS
    solves captured into a CUDA graph, the chunk runner's way
    (``k4_ab.graph_ms``)."""
    rows = []
    for bw in bws:
        for i, m in enumerate(lengths):
            seg = synthetic_segments(n, m, bw, seed=200 + i, device="cuda")
            r = torch.randn(n, dtype=torch.float64, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(i))
            ms = graph_ms(lambda: tri_stream.band_segments_solve(seg, r), SEG_REPS)
            rows.append(dict(n=n, bw=bw, max_seg=m, chunks=seg.chunks.shape[0] - 1, rows=seg.rows, ms=ms))
            del seg, r
    return rows


def fit_segment_model(rows: list) -> lim.SegmentModel:
    """``limits.SegmentModel`` by non-negative least squares on the solve
    times of ``rows``, relative (every band counts alike)."""
    t = np.array([r["ms"] * 1e-3 for r in rows])
    X = np.array([[1.0, r["n"] * (4 * (r["bw"] + 1) + 16), r["max_seg"] * (r["bw"] + 1)] for r in rows]) / t[:, None]
    fixed, per_byte, entry = nnls(X, np.ones_like(t))[0]
    return lim.SegmentModel(fixed_s=float(fixed), bytes_per_s=float(1.0 / per_byte), entry_s=float(entry))


def fit_peak(points: list) -> lim.PeakModel:
    """peak = multiple x factor bytes + constant by least squares over
    ``points`` (dicts with factor_bytes and peak_bytes), the constant then
    raised until no point lies above the line."""
    F = np.array([p["factor_bytes"] for p in points], float)
    P = np.array([p["peak_bytes"] for p in points], float)
    m, c = np.linalg.lstsq(np.stack([F, np.ones_like(F)], 1), P, rcond=None)[0]
    c = max(c, float(np.max(P - m * F)))
    return lim.PeakModel(float(m), float(np.ceil(c)))


def _band_terms(r: dict) -> list:
    """The terms of ``limits.BandModel`` for one layout, per unit of each
    coefficient (1 / bytes_per_s, tile_s, step_s, row_s)."""
    T, B, nb = r["T"], r["B"], r["nb"]
    return [2.0 * T * B * B * 4, 2.0 * T, 2.0 * nb, 2.0 * nb * B]


def _fit_terms(rows: list) -> lim.BandModel:
    """One form's ``limits.BandModel`` terms by non-negative least squares
    on the solve times of ``rows``, relative (every layout counts alike)."""
    t = np.array([r["ms"] * 1e-3 for r in rows])
    X = np.array([_band_terms(r) for r in rows]) / t[:, None]
    inv_bw, tile, step, row = nnls(X, np.ones_like(t))[0]
    return lim.BandModel(bytes_per_s=float(1.0 / inv_bw) if inv_bw > 0 else float("inf"), tile_s=float(tile),
                         step_s=float(step), row_s=float(row))


def fit_band_model(rows: list) -> lim.BandModel:
    """``limits.BandModel``: the two-hop form's terms fitted to the rows of
    nbw > NBW_CHAIN, its ``one_hop`` terms to the others (each form's cost
    has its own shape: csrc/tri_stream.cu)."""
    one = [r for r in rows if r["nbw"] <= lim.NBW_CHAIN]
    two = [r for r in rows if r["nbw"] > lim.NBW_CHAIN]
    return dataclasses.replace(_fit_terms(two), one_hop=_fit_terms(one))


def band_ranking(rows: list, model) -> list:
    """Per band: the blocks ordered by measured time and by ``model``, and
    whether the model's pick is the fastest measured, or ties it within
    K3_TIE."""
    out = []
    for label in dict.fromkeys(r["band"] for r in rows):
        rs = [r for r in rows if r["band"] == label]
        ms = {r["B"]: r["ms"] for r in rs}
        measured = [r["B"] for r in sorted(rs, key=lambda r: r["ms"])]
        predicted = [r["B"] for r in sorted(rs, key=lambda r: model(r["T"], r["B"], r["nb"]))]
        out.append(dict(band=label, measured=measured, model=predicted,
                        model_ms={r["B"]: model(r["T"], r["B"], r["nb"]) * 1e3 for r in rs},
                        pick_is_fastest=ms[predicted[0]] <= (1 + K3_TIE) * ms[measured[0]]))
    return out


def measure(problems: dict, device: torch.device) -> dict:
    """Every measurement of the module docstring; ``problems`` maps a grid
    shape to its problem (built here when missing)."""
    peaks = []
    for mode, shape in PEAK_BUILDS:
        if shape not in problems:
            problems[shape] = grid_problem(shape)
        peaks.append(dict(build_peak(problems[shape], mode, device), grid=f"{shape[0]}x{shape[1]}"))
    peaks.append(dict(synthetic_band_peak(*PUSHBOX[1:]), grid=PUSHBOX[0] + " (synthetic)"))
    return dict(peaks=peaks, k3=k3_times(), k3_segments=segment_times())


def fit(measured: dict) -> dict:
    models = {mode: fit_peak([p for p in measured["peaks"] if p["mode"] == mode])
              for mode in ("packed", "banded", "precond")}
    band = fit_band_model(measured["k3"])
    return dict(peaks={k: m._asdict() for k, m in models.items()},
                band_model=dataclasses.asdict(band),
                ranking=band_ranking(measured["k3"], band),
                segment_model=dataclasses.asdict(fit_segment_model(measured["k3_segments"])))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("card_fit: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    device = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    measured = measure({}, device)
    out = dict(card=card, total_bytes=torch.cuda.get_device_properties(device).total_memory,
               **measured, fit=fit(measured))
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
