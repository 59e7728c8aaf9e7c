"""K1's time at each n_pad for one checkout of the port, to compare two
checkouts on one card.

    python3 cuadmm_tpu_torch/k1_ab.py ROOT [LABEL] [--rhs B]

Imports ``cuadmm_tpu_torch`` from the checkout at ROOT, so this script can
time an older K1 too (its kernel is built into ROOT's build/), and times
``fused_spd_apply`` with CUDA events at each N_PADS size on the same input
for every checkout: a seeded unit-diagonal random lower triangle M (zeros
above the diagonal) and a seeded r, made on the card. A size the checkout
rejects is recorded as null. Beside each time: the bound over the triangle
(4 n(n+1)/2 bytes of M, r in and y out, at 3.35 TB/s), the share, and one
``torch.linalg.multi_dot`` call (two cuBLAS matvecs) as the library time.
Each time is the least of ROUNDS rounds of REPS launches. Prints the card
line, then one JSON line.

With ``--rhs B`` (B > 1) r is (B, n_pad), B seeded right-hand sides:
the time of one ``fused_spd_apply`` call over all B (null where the
checkout takes no batch), beside B one-RHS calls (``one_rhs_ms``, what a
checkout without K1 over B launches), the bound over the triangle read
once (R in and Y out, 8 B n_pad bytes) and ``multi_dot`` as M^T (M R^T).

To compare checkouts A and B, run A, B, B, A, each in its own process, in
one call on the card.
"""

import json
import sys
from pathlib import Path

import torch

N_PADS = (5120, 17152, 32512, 32768, 44416, 65536)
RHS_N_PADS = (5120, 18816, 44416)  # with --rhs: 18,816 is the family cell's factor
REPS, ROUNDS = 20, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)


def unit_lower(n: int, seed: int) -> tuple:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randn((n, n), device="cuda", generator=gen).mul_(0.1 / n**0.5).tril_(-1)
    m.diagonal().fill_(1.0)
    return m, torch.randn(n, device="cuda", generator=gen)


def time_ms(fn) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(ROUNDS):
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / REPS)
    return best


def main() -> None:
    args = sys.argv[1:]
    rhs = 1
    if "--rhs" in args:
        at = args.index("--rhs")
        rhs = int(args[at + 1])
        del args[at:at + 2]
    root = Path(args[0]).resolve()
    label = args[1] if len(args) > 1 else root.name
    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: needs a CUDA device")
    sys.path[0] = str(root)  # in place of this script's directory
    from cuadmm_tpu_torch.device import card_line
    from cuadmm_tpu_torch.ops import precond_apply

    print(card_line())
    out = dict(label=label, root=str(root), rhs=rhs, k1={})
    for i, n in enumerate(N_PADS if rhs == 1 else RHS_N_PADS):
        m, r = unit_lower(n, seed=i)
        if rhs > 1:
            r = torch.randn((rhs, n), device="cuda", generator=torch.Generator(device="cuda").manual_seed(100 + i))
        bound_ms = (4.0 * n * (n + 1) / 2 + 8.0 * rhs * n) / HBM_BYTES_PER_S * 1e3
        row = dict(bound_ms=bound_ms, library_ms=time_ms(lambda: torch.linalg.multi_dot([m.T, m, r.T if rhs > 1 else r])))
        if rhs > 1:
            try:
                row["one_rhs_ms"] = time_ms(lambda: [precond_apply.fused_spd_apply(m, v) for v in r])
            except ValueError as err:
                row.update(one_rhs_ms=None, one_rhs_rejected=str(err))
        try:
            y = precond_apply.fused_spd_apply(m, r)
        except ValueError as err:  # an n_pad this checkout's K1 does not take
            row.update(ms=None, share=None, rejected=str(err))
        else:
            ref = precond_apply.fused_spd_apply_ref(m, r)
            rel = float(torch.linalg.norm(y - ref) / torch.linalg.norm(ref))
            ms = time_ms(lambda: precond_apply.fused_spd_apply(m, r))
            row.update(ms=ms, share=bound_ms / ms, rel_err=rel)
        out["k1"][str(n)] = row
        del m, r
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
