"""The poly filter's one-triangle route against its full-GEMM route on the
card: checks, the crossover that sets ``ops/polyfilter.py::TRI_MIN_N``,
and the parts' times at QUASAR-500's n = 2004.

    python3 -m cuadmm_tpu_torch.poly_ab [--sizes N,...] [--out FILE]

1. Checks: the mirror kernel (csrc/sym_mirror.cu) against ``mirror_ref``
   at n = 1-2004 in f64 and f32, with and without W, scale and shift, in
   place and not, NaN written below the diagonal of T and W (it must not
   leak); syrk and syrkx against ``torch.mm`` on the upper triangle;
   ``psd_project_poly`` by both routes at n = 600 and 2004 (relative to
   the largest |entry|), the triangle route's output exactly symmetric,
   and its replay from a CUDA graph bitwise equal to the eager call.
2. Crossover: ``psd_project_poly`` on one random symmetric matrix by each
   route at n = 256-2048 (or ``--sizes``), batch 1, f64 and f32, each as
   a replayed CUDA graph of REPS calls (as the chunk runner runs it).
3. Parts at n = 2004: one ``torch.mm``, ``syrk``, ``syrkx``, the mirror
   kernel with and without W beside its bound (bytes at 3.35 TB/s),
   ``mirror_ref`` on the card.

Prints the card line, then one JSON line a row (also written to
``--out``). Checks raise; times are the least of ROUNDS.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from cuadmm_tpu_torch.device import card_line, resolve_device
from cuadmm_tpu_torch.k4_ab import graph_ms, sym_batch
from cuadmm_tpu_torch.ops import polyfilter, sym_products

REPS, ROUNDS = 10, 3
CROSS_N = (256, 384, 512, 640, 768, 1024, 1536, 2004, 2048)
PEAK_BYTES_S = 3.35e12
# The route against the GEMM route, of the largest |entry| (f32: sums in
# another order, amplified by the filter's slope near a zero eigenvalue).
TOL = {torch.float64: 1e-10, torch.float32: 5e-5}


def _emit(rows: list, row: dict) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def _route(tri: bool):
    """psd_project_poly with the route forced on or off."""
    def run(x):
        keep = polyfilter.TRI_MIN_N
        polyfilter.TRI_MIN_N = dict.fromkeys(keep, 1 if tri else 1 << 62)
        try:
            return polyfilter.psd_project_poly(x)
        finally:
            polyfilter.TRI_MIN_N = keep
    return run


def check_mirror(rows: list) -> None:
    for dtype in (torch.float64, torch.float32):
        tol = 1e-15 if dtype == torch.float64 else 1e-6
        for n in (1, 2, 31, 32, 33, 100, 2004):
            t = sym_batch(n, 1, dtype, n)[0]
            w = sym_batch(n, 1, dtype, n + 1)[0]
            s = torch.full((1, 1, 1), 0.37, dtype=dtype, device="cuda")
            for kw in (dict(), dict(alpha=2.5, shift=-0.75), dict(add=w, add_coef=-1.25, shift=4.0),
                       dict(add=w, scale=s, alpha=0.5)):
                ref = sym_products.mirror_ref(t, torch.empty_like(t), kw.get("alpha", 1.0), kw.get("scale"),
                                              kw.get("shift", 0.0), kw.get("add"), kw.get("add_coef", 1.0))
                nan_t = t + torch.full_like(t, float("nan")).tril_(-1)
                nan_w = None if "add" not in kw else w + torch.full_like(w, float("nan")).tril_(-1)
                kw2 = dict(kw, add=nan_w) if nan_w is not None else kw
                out = sym_products.mirror(nan_t, torch.empty_like(t), **kw2)
                inplace = sym_products.mirror(nan_t.clone(), **kw2)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-300))
                ok = (bool(torch.isfinite(out).all()) and torch.equal(out, out.mT) and torch.equal(out, inplace)
                      and err <= tol)
                if not ok:
                    raise AssertionError(f"mirror n={n} {dtype} {sorted(kw)}: rel err {err}")
        _emit(rows, dict(check="mirror", dtype=str(dtype), ok=True))


def check_products(rows: list) -> None:
    for dtype in (torch.float64, torch.float32):
        tol = 1e-13 if dtype == torch.float64 else 1e-5
        for n in (64, 600, 2004):
            a = sym_batch(n, 1, dtype, 3)[0]
            b = a @ a  # commutes with a
            for name, got, ref in (
                    ("syrk", sym_products.syrk(a, torch.empty_like(a), alpha=-0.5), -0.5 * (a @ a.mT)),
                    ("syrkx", sym_products.syrkx(a, b, torch.empty_like(a)), a @ b.mT)):
                torch.cuda.synchronize()
                err = float((got.triu() - ref.triu()).abs().max() / ref.abs().max())
                if not err <= tol:
                    raise AssertionError(f"{name} n={n} {dtype}: rel err {err}")
        _emit(rows, dict(check="syrk_syrkx", dtype=str(dtype), ok=True))


def check_route(rows: list) -> None:
    for dtype in (torch.float64, torch.float32):
        for n in (600, 2004):
            x = sym_batch(n, 1, dtype, 7)
            full, tri = _route(False)(x), _route(True)(x)
            torch.cuda.synchronize()
            err = float((tri - full).abs().max() / x.abs().max())
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                _route(True)(x)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = _route(True)(x)
            graph.replay()
            torch.cuda.synchronize()
            same = torch.equal(replayed, tri)
            if not (err <= TOL[dtype] and torch.equal(tri, tri.mT) and same):
                raise AssertionError(f"route n={n} {dtype}: rel err {err}, graph replay equal {same}")
            _emit(rows, dict(check="route", n=n, dtype=str(dtype), rel_err_vs_gemm=err, graph_equal=same))


def crossover(rows: list, sizes) -> None:
    for dtype in (torch.float64, torch.float32):
        for n in sizes:
            x = sym_batch(n, 1, dtype, n)
            gemm = graph_ms(lambda: _route(False)(x), REPS, ROUNDS)
            tri = graph_ms(lambda: _route(True)(x), REPS, ROUNDS)
            _emit(rows, dict(crossover=n, dtype=str(dtype), gemm_ms=gemm, tri_ms=tri, tri_over_gemm=tri / gemm))


def parts(rows: list, n: int = 2004) -> None:
    for dtype in (torch.float64, torch.float32):
        a = sym_batch(n, 1, dtype, 11)[0]
        b = a @ a
        out = torch.empty_like(a)
        s = torch.full((1, 1, 1), 0.5, dtype=dtype, device="cuda")
        size = a.element_size()
        flops_full = 2.0 * n ** 3
        f = {
            "mm": (lambda: torch.mm(a, b, out=out), flops_full),
            "syrk": (lambda: sym_products.syrk(a, out), flops_full / 2),
            "syrkx": (lambda: sym_products.syrkx(a, b, out), flops_full / 2),
        }
        for name, (fn, flops) in f.items():
            ms = graph_ms(fn, REPS, ROUNDS)
            _emit(rows, dict(part=name, n=n, dtype=str(dtype), ms=ms, tflops_useful=flops / ms / 1e9))
        tri_bytes = (n * (n + 1) // 2) * size
        for name, kw, nbytes in (("mirror", {}, tri_bytes + n * n * size),
                                 ("mirror_add_scale", dict(add=b, scale=s, alpha=0.5), 2 * tri_bytes + n * n * size)):
            ms = graph_ms(lambda: sym_products.mirror(a, out, **kw), REPS, ROUNDS)
            ref_ms = graph_ms(lambda: sym_products.mirror_ref(a, out, kw.get("alpha", 1.0), kw.get("scale"), 0.0,
                                                              kw.get("add"), 1.0), REPS, ROUNDS)
            bound = nbytes / PEAK_BYTES_S * 1e3
            _emit(rows, dict(part=name, n=n, dtype=str(dtype), ms=ms, bound_ms=bound, share=bound / ms,
                             plain_ms=ref_ms, bytes=nbytes))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here, one JSON line each")
    ap.add_argument("--sizes", default=",".join(map(str, CROSS_N)), help="the crossover's n, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("poly_ab: needs a CUDA device")
    resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    rows: list = [dict(card=card, torch=torch.__version__, cuda=torch.version.cuda)]
    check_mirror(rows)
    check_products(rows)
    check_route(rows)
    parts(rows)
    crossover(rows, [int(v) for v in args.sizes.split(",")])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
