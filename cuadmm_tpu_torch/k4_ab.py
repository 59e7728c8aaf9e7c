"""K4's time at each K4_SHAPES point, in f64 and f32, for one checkout of
the port, to compare two checkouts on one card.

    python3 cuadmm_tpu_torch/k4_ab.py ROOT [LABEL]

Imports ``cuadmm_tpu_torch`` from the checkout at ROOT, so this script can
time an older K4 too (its kernel is built into ROOT's build/), and times
``jacobi_eigh`` on the same seeded symmetric batch (made on the card) at
this script's own checkout's ``ops/jacobi.py::K4_SHAPES`` for every
checkout: K4 as the checkout picks its plan and K4 +
``reconstruct_clamped``, each as a replayed CUDA graph of REPS calls (the
chunk runner replays K4 so: device time, no host launches), beside
``torch.linalg.eigh`` + ``reconstruct_clamped`` and ``torch.linalg.eigh``
alone (the library call), launched eagerly with eigh's status check on the
host, as the runner runs eigh. Where the checkout has launch plans
(``jacobi.PLANS``), each row names the plan that ran and checks it:
finite, the same bits over two launches, and its sorted eigenvalues and
clamped projection against f64 ``torch.linalg.eigh`` of the same input,
relative to the largest |entry| (printed, not gated: chip_smoke.py and the
``cuda`` tests gate K4); then both plans are timed at PLAN_SHAPES, the
points that set ``ops/jacobi.py::k4_plan``'s thresholds. Each time is the
least of ROUNDS. Prints the card line, then one JSON line.

To compare checkouts A and B, run A, B, B, A, each in its own process, in
one call on the card.
"""

import ast
import json
import sys
from pathlib import Path

import torch

# Both plans at more batches of the small n, where the "warp" plan's
# warps could fill the card.
PLAN_SHAPES = tuple((n, b) for n in (4, 5, 6, 7, 8, 13, 16, 24) for b in (64, 512, 1024, 1556, 4096))
REPS, ROUNDS = 10, 3


def own_k4_shapes() -> tuple:
    """``K4_SHAPES`` of this script's checkout (ops/jacobi.py), read from its
    source: the package imported is ROOT's, which may predate the list."""
    tree = ast.parse((Path(__file__).resolve().parent / "ops" / "jacobi.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "K4_SHAPES")
    return ast.literal_eval(node.value)


def sym_batch(n: int, batch: int, dtype, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randn((batch, n, n), dtype=dtype, device="cuda", generator=gen)
    return (m + m.transpose(1, 2)) / 2


def _best(run, reps: int, rounds: int) -> float:
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(rounds):
        start.record()
        run()
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def eager_ms(fn) -> float:
    """Milliseconds a call, REPS calls launched eagerly."""
    fn()

    def run():
        for _ in range(REPS):
            fn()
    return _best(run, REPS, ROUNDS)


def graph_ms(fn, reps: int = REPS, rounds: int = ROUNDS) -> float:
    """Milliseconds a call, ``reps`` calls captured into one CUDA graph and
    replayed: the least of ``rounds`` timed replays after one untimed one
    (the first call, off the capture, builds and sets up)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = _best(graph.replay, reps, rounds)
    del graph
    return ms


def errors(mats, w, v, reconstruct_clamped) -> dict:
    """Sorted w and the clamped projection against f64 eigh, relative to
    the largest |entry|; V^T V - I absolute."""
    m64 = mats.double()
    we, ve = torch.linalg.eigh(m64)
    scale = float(m64.abs().max())
    w, v = w.double(), v.double()
    eye = torch.eye(mats.shape[-1], dtype=torch.float64, device=mats.device)
    return dict(
        rel_err_w=float((w.sort(dim=1).values - we).abs().max()) / scale,
        rel_err_proj=float((reconstruct_clamped(w, v) - reconstruct_clamped(we, ve)).abs().max()) / scale,
        orth_err=float((v.transpose(1, 2) @ v - eye).abs().max()),
        finite=bool(torch.isfinite(w).all() and torch.isfinite(v).all()),
    )


def main() -> None:
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2] if len(sys.argv) > 2 else root.name
    if not torch.cuda.is_available():
        raise SystemExit("k4_ab: needs a CUDA device")
    shapes = own_k4_shapes()
    sys.path[0] = str(root)  # in place of this script's directory
    from cuadmm_tpu_torch.device import card_line
    from cuadmm_tpu_torch.ops import jacobi
    from cuadmm_tpu_torch.ops.projection import reconstruct_clamped

    print(card_line(), flush=True)
    plans = getattr(jacobi, "PLANS", ())
    out = dict(label=label, root=str(root), plans=list(plans), k4=[], plan_shapes=[])
    for dtype in (torch.float64, torch.float32):
        for n, batch in shapes:
            mats = sym_batch(n, batch, dtype, seed=n)
            row = dict(n=n, batch=batch, dtype=str(dtype).split(".")[-1])
            row["k4_ms"] = graph_ms(lambda: jacobi.jacobi_eigh(mats))
            row["k4_proj_ms"] = graph_ms(lambda: reconstruct_clamped(*jacobi.jacobi_eigh(mats)))
            row["eigh_proj_ms"] = eager_ms(lambda: reconstruct_clamped(*torch.linalg.eigh(mats)))
            row["library_ms"] = eager_ms(lambda: torch.linalg.eigh(mats))
            if plans:
                row["plan"] = jacobi.k4_plan(n, batch, dtype, jacobi.card_smem(mats.device.index))
                w, v = jacobi.jacobi_eigh(mats)
                w2, v2 = jacobi.jacobi_eigh(mats)
                row.update(bitwise=bool(torch.equal(w, w2) and torch.equal(v, v2)),
                           **errors(mats, w, v, reconstruct_clamped))
            out["k4"].append(row)
            print("K4 " + json.dumps(row), flush=True)
            del mats
        for n, batch in PLAN_SHAPES if plans else ():
            mats = sym_batch(n, batch, dtype, seed=n)
            row = dict(n=n, batch=batch, dtype=str(dtype).split(".")[-1],
                       plan=jacobi.k4_plan(n, batch, dtype, jacobi.card_smem(mats.device.index)))
            for plan in plans:
                row[f"{plan}_ms"] = graph_ms(lambda: jacobi.jacobi_eigh(mats, _plan=plan))
            out["plan_shapes"].append(row)
            print("K4 plans " + json.dumps(row), flush=True)
            del mats
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
