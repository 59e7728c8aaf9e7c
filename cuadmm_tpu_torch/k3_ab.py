"""K3's (and K2's) solve time for one checkout of the port, to compare two
checkouts on one card, and the timeline of one K3 sweep.

    python3 cuadmm_tpu_torch/k3_ab.py ROOT [LABEL] [--forms] [--timeline]

Imports ``cuadmm_tpu_torch`` from the checkout at ROOT, so this script can
time an older K3 too (its kernel is built into ROOT's build/). On synthetic
factors made on the card as ``card_fit._synthetic_band`` makes them (K2's
packed triangle alike), it times each solve as a replayed CUDA graph of
REPS solves, the least of ROUNDS (``k4_ab.graph_ms``: the chunk runner
replays K2 and K3 so, device time and no host launches), at POINTS: the
20x120 grid's band at B 1024, 512 and 256, the limits phase's "mid",
"pendulum N=80" and "PushBox N=30" bands at B 1024, and K2 at the grid's
packed layout. Each row has the ms, the bound from bytes (every tile read
once a sweep, two sweeps, r in and y out, at 3.35 TB/s), its share, the
form that ran and the error against the plain version (printed, not
gated: chip_smoke.py and the ``cuda`` tests gate K3).

``--forms`` (a checkout with the one-hop form) also times both forms at
B 1024, nb 67 and nbw 1-6 (the data behind ``limits.NBW_CHAIN``).

``--timeline`` builds the kernel once more with -DCUADMM_TRI_STAMPS (its
own library name; the library that ships and is timed has no stamps) and
records %globaltimer_lo at each work item's start, when its wait for the
newest solved data began and ended, and at its write, in one solve of
each form at the grid's band at B 1024. Per block step it prints the
producer spread (first to last write of the items a hop waits for), the
consumers' wait and the time from the last producer's write to the first
consumer seeing it; the full per-step rows go to
chiprun_out/k3_timeline_<label>.json.

Prints the card line, then one JSON line. To compare checkouts A and B,
run A, B, B, A, each in its own process, in one call on the card.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
REPS, ROUNDS = 20, 5
# (label, n, bandwidth, block): the 20x120 grid's band under RCM (nbw 1),
# and the limits phase's other bands at B 1024 (nbw 5, 2 and 21).
POINTS = (("grid 20x120", 68350, 4, 1024), ("grid 20x120", 68350, 4, 512), ("grid 20x120", 68350, 4, 256),
          ("mid", 100000, 5000, 1024), ("pendulum N=80", 112028, 1615, 1024),
          ("PushBox N=30", 154256, 20512, 1024))
PACKED = ("packed grid 20x120", 68350)
FORM_NBW = (1, 2, 3, 4, 5, 6)  # --forms: both forms at B 1024, nb 67
FORM_NAME = {"chain": "one-hop", "two_hop": "two-hop"}
STAMPS = 5  # words an item: start, wait begun, thread 0 saw its words, slab and data ready, written


def _packed_factor(lay, seed: int) -> torch.Tensor:
    """Packed tiles on the card: off-diagonal N(0, 1/(B (nb-1))), diagonal
    tiles I plus a tenth of that noise (chip_smoke.py's synthetic factor)."""
    from cuadmm_tpu_torch.ops import tri_stream

    gen = torch.Generator(device="cuda").manual_seed(seed)
    B = lay.block
    tiles = torch.empty((lay.T + 1, B, B), device="cuda").normal_(generator=gen)
    tiles.mul_(1.0 / (B * max(lay.nb - 1, 1)) ** 0.5)
    eye = torch.eye(B, device="cuda")
    for k in range(lay.nb):
        tiles[tri_stream.tid(k, k)].mul_(0.1).add_(eye)
    return tiles


def tiles_read(lay) -> int:
    """Tiles a sweep reads: the packed triangle, or the band's used slots."""
    if hasattr(lay, "nbw"):
        return sum(min(i, lay.nbw) + 1 for i in range(lay.nb))
    return lay.T


def bound_ms(lay) -> float:
    return (2 * tiles_read(lay) * lay.block**2 * 4 + 8.0 * lay.n_pad) / HBM_BYTES_PER_S * 1e3


def _form(tri_stream, lay, form=None) -> str:
    """The form ``lay`` runs in: ``form`` where given, else the checkout's
    ``band_form`` (two-hop in a checkout without the one-hop form)."""
    if form or not hasattr(lay, "nbw") or not hasattr(tri_stream, "band_form"):
        return form or "two_hop"
    return tri_stream.band_form(lay)


def _solver(tri_stream, tiles, lay, form):
    """The solve of ``lay`` in ``form`` (a checkout without the one-hop
    form runs its own)."""
    if not hasattr(lay, "nbw"):
        return lambda r: tri_stream.packed_solve(tiles, r, lay)
    if not hasattr(tri_stream, "band_form"):
        return lambda r: tri_stream.band_solve(tiles, r, lay)
    chain = tri_stream.band_chain(tiles, lay) if form == "chain" else None
    return lambda r: tri_stream.band_solve(tiles, r, lay, chain=chain, form=form)


def time_point(tri_stream, graph_ms, label, lay, tiles, r, form=None) -> dict:
    form = _form(tri_stream, lay, form)
    solve = _solver(tri_stream, tiles, lay, form)
    plain = (tri_stream.band_solve_ref if hasattr(lay, "nbw") else tri_stream.packed_solve_ref)(tiles, r, lay)
    y = solve(r)
    rel = float(torch.linalg.norm(y - plain) / torch.linalg.norm(plain))
    ms = graph_ms(lambda: solve(r), REPS, ROUNDS)
    b = bound_ms(lay)
    row = dict(point=label, n=lay.n, B=lay.block, nb=lay.nb, nbw=getattr(lay, "nbw", None),
               form=FORM_NAME[form], ms=ms, bound_ms=b, share_of_bound=b / ms, rel_err=rel,
               bitwise=bool(torch.equal(solve(r), y)))
    del solve
    return row


def _rel_ns(t: np.ndarray, ref: int) -> np.ndarray:
    """globaltimer_lo stamps as signed ns from ``ref`` (wrap-safe); NaN
    where a stamp was not written (0)."""
    d = ((t.astype(np.int64) - ref) % 2**32).astype(np.float64)
    d[d >= 2**31] -= 2**32
    d[t == 0] = np.nan
    return d


def _hop_rows(producers: list, consumers: list, t: np.ndarray) -> list:
    """Per hop (the items whose writes a set of items waits for): the
    producers' spread (first to last write), the consumers' median wait
    (wait begun to slab and data ready), last producer write to the first
    consumer's thread 0 seeing its words, the consumers' median time from
    seeing their words to having slab and data ready (the bytes still on
    the chain), and the step time (last write to last write)."""
    rows, prev_last = [], None
    for prod, cons in zip(producers, consumers):
        w = t[prod, 4]
        last = np.nanmax(t[cons, 4])
        rows.append(dict(producer_spread_us=float(np.nanmax(w) - np.nanmin(w)) / 1e3,
                         consumer_wait_us=float(np.nanmedian(t[cons, 3] - t[cons, 1])) / 1e3,
                         last_write_to_first_seen_us=float(np.nanmin(t[cons, 2]) - np.nanmax(w)) / 1e3,
                         seen_to_ready_us=float(np.nanmedian(t[cons, 3] - t[cons, 2])) / 1e3,
                         step_us=None if prev_last is None else float(last - prev_last) / 1e3))
        prev_last = last
    return rows


def timeline(tri_stream, lay, tiles, r) -> dict:
    """One stamped solve of each form at ``lay``; per-step hop rows of the
    forward sweep and the medians of both sweeps."""
    lib = tri_stream._load("stamps")
    out = {}
    for form in ("two_hop", "chain"):
        chain = tri_stream.band_chain(tiles, lay) if form == "chain" else None
        if form == "chain":
            per = lay.block // tri_stream.CHAIN_ITEM
            n_items = lay.nb * per
        else:
            tabs = [tri_stream._work_table(tri_stream._steps(tb, tr), lay.block)
                    for tb, tr in zip(tri_stream._sweep_tables(lay), (False, True))]
            n_items = max(len(tb[0]) for tb in tabs)
        bufs = [torch.zeros(STAMPS * n_items, dtype=torch.int32, device="cuda") for _ in range(2)]
        tri_stream._check(lib, lib.cuadmm_tri_stream_set_stamps(bufs[0].data_ptr(), bufs[1].data_ptr()), "stamps")
        for _ in range(2):  # the second solve's stamps are kept: the first builds tables and plans
            for b in bufs:
                b.zero_()
            tri_stream._solve(tiles, r, lay, "band_solve", chain=chain, form=form, variant="stamps")
        torch.cuda.synchronize()
        tri_stream._check(lib, lib.cuadmm_tri_stream_set_stamps(None, None), "stamps")
        sweeps = {}
        for sweep, buf in zip(("forward", "backward"), bufs):
            raw = buf.cpu().numpy().view(np.uint32).reshape(n_items, STAMPS)
            t = _rel_ns(raw, int(raw[raw > 0].min()))
            if form == "chain":
                items = np.arange(n_items).reshape(lay.nb, per)
                prods, cons = [list(items[s - 1]) for s in range(1, lay.nb)], [list(items[s]) for s in range(1, lay.nb)]
                hops = {"hop": _hop_rows(prods, cons, t)}
            else:
                items, _, _ = tabs[0 if sweep == "forward" else 1]
                step, diag = items[:, 1], items[:, 3] < 0
                by = lambda s, d: list(np.flatnonzero((step == s) & (diag == d)))
                hops = {"hop 1 (x to partials)": _hop_rows([by(s - 1, True) for s in range(1, lay.nb)],
                                                           [by(s, False) for s in range(1, lay.nb)], t),
                        "hop 2 (partials to x)": _hop_rows([by(s, False) for s in range(1, lay.nb)],
                                                           [by(s, True) for s in range(1, lay.nb)], t)}
            span = float(np.nanmax(t[:, 4]) - np.nanmin(t[:, 0])) / 1e3
            diffs = np.diff(np.unique(raw[raw > 0]))
            summary = {name: {k: float(np.nanmedian([row[k] for row in rows if row[k] is not None]))
                              for k in rows[0]} for name, rows in hops.items()}
            sweeps[sweep] = dict(sweep_us=span, medians=summary, timer_step_ns=int(diffs.min()) if len(diffs) else None,
                                 rows=hops if sweep == "forward" else None)
            print(f"K3 timeline {form} {sweep} " + json.dumps(dict(sweep_us=span, medians=summary)), flush=True)
        out[form] = sweeps
        del chain
    return out


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0]).resolve()
    label = args[1] if len(args) > 1 else root.name
    if not torch.cuda.is_available():
        raise SystemExit("k3_ab: needs a CUDA device")
    sys.path[0] = str(root)  # in place of this script's directory
    from cuadmm_tpu_torch.card_fit import _synthetic_band
    from cuadmm_tpu_torch.device import card_line
    from cuadmm_tpu_torch.k4_ab import graph_ms
    from cuadmm_tpu_torch.ops import tri_stream

    print(card_line(), flush=True)
    out = dict(label=label, root=str(root), nbw_chain=getattr(tri_stream, "NBW_CHAIN", None), k3=[], k2=None)
    gen = lambda seed: torch.Generator(device="cuda").manual_seed(seed)
    for i, (name, n, bw, B) in enumerate(POINTS):
        lay = tri_stream.make_band_layout(n, bw, block=B)
        tiles = _synthetic_band(lay, seed=100 + i, diag=1.0)
        r = torch.randn(n, device="cuda", generator=gen(i))
        row = time_point(tri_stream, graph_ms, name, lay, tiles, r)
        out["k3"].append(row)
        print("K3 " + json.dumps(row), flush=True)
        if "--timeline" in sys.argv and name.startswith("grid") and B == 1024:
            out["timeline"] = timeline(tri_stream, lay, tiles, r)
            rep = Path("chiprun_out") / f"k3_timeline_{label}.json"
            rep.parent.mkdir(exist_ok=True)
            rep.write_text(json.dumps(out["timeline"]))
            for form in out["timeline"].values():
                for sw in form.values():
                    sw.pop("rows", None)
        del tiles, r
        torch.cuda.empty_cache()
    lay = tri_stream.make_layout(PACKED[1])
    tiles = _packed_factor(lay, seed=7)
    r = torch.randn(lay.n, device="cuda", generator=gen(7))
    out["k2"] = time_point(tri_stream, graph_ms, PACKED[0], lay, tiles, r)
    print("K2 " + json.dumps(out["k2"]), flush=True)
    del tiles, r
    torch.cuda.empty_cache()
    if "--forms" in sys.argv:
        out["forms"] = []
        for k in FORM_NBW:
            lay = tri_stream.make_band_layout(68350, 1024 * (k - 1) + 1, block=1024)
            tiles = _synthetic_band(lay, seed=200 + k, diag=1.0)
            r = torch.randn(lay.n, device="cuda", generator=gen(k))
            for form in ("two_hop", "chain"):
                row = time_point(tri_stream, graph_ms, f"nbw {lay.nbw}", lay, tiles, r, form)
                out["forms"].append(row)
                print("K3 form " + json.dumps(row), flush=True)
            del tiles, r
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
