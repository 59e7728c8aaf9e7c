"""Projection-method calibration sweep on the card.

    python -m cuadmm_tpu_torch.eig_sweep --dtype float64

Port of benchmarks/eig_sweep.py. For each (block size n, batch count)
point it times the three projection methods of ops/projection.py on one
batch of random symmetric matrices: eigh + reconstruct, the polynomial
filter, and the Jacobi kernel K4 + reconstruct (n <= 64 only, as the JAX
sweep times jacobi). It writes one JSON line per point to
``cuadmm_tpu_torch/data/eig_sweep_cuda_<dtype>.jsonl``, the table that
``projection="auto"`` reads on CUDA (ops/dispatch.py). Each row names the
card and its power limit.

Timing: CUDA events around k passes, each on a fresh input (the batch
scaled by 1 + 1e-6 i, which keeps the spectrum's shape), after one
untimed pass that builds the kernel and warms the libraries. Feeding a
projected, near-PSD output back in would flatter whichever method ran
first (benchmarks/eig_sweep.py:61-82). Each method is timed as the chunk
runner (solver/step.py) runs it: "poly" and "jacobi" as one CUDA graph of
the k passes, replayed (eager timing of a small bucket measures the host's
launches, which a replayed iteration does not pay); "eigh" eagerly, with
its status check on the host, as the runner runs it between two graphs.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cuadmm_tpu_torch.device import card_line, resolve_device
from cuadmm_tpu_torch.k4_ab import graph_ms
from cuadmm_tpu_torch.ops.dispatch import sweep_path
from cuadmm_tpu_torch.ops.jacobi import jacobi_eigh
from cuadmm_tpu_torch.ops.polyfilter import psd_project_poly
from cuadmm_tpu_torch.ops.projection import reconstruct_clamped


def eigh_project(mats: torch.Tensor) -> torch.Tensor:
    return reconstruct_clamped(*torch.linalg.eigh(mats))


def jacobi_project(mats: torch.Tensor) -> torch.Tensor:
    return reconstruct_clamped(*jacobi_eigh(mats))


JACOBI_MAX_N = 64  # jacobi is timed up to this n, as benchmarks/eig_sweep.py:124 does
SIZES = (2, 4, 8, 16, 32, 64, 128, 256)
BATCHES = (1, 8, 64, 512, 4096)


def time_ms(fn, x: torch.Tensor, k: int = 16) -> float:
    """Milliseconds per pass over k fresh inputs, launched eagerly, from
    CUDA events."""
    fn(x)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(k):
        fn(x * (1.0 + 1e-6 * i))
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / k


def time_graph_ms(fn, x: torch.Tensor, k: int = 16) -> float:
    """Milliseconds per pass over k fresh inputs, the k passes captured into
    one CUDA graph and replayed once (after one untimed replay), from CUDA
    events (``k4_ab.graph_ms``)."""
    xs = [x * (1.0 + 1e-6 * i) for i in range(k)]
    return graph_ms(lambda: [fn(xi) for xi in xs], reps=1, rounds=1) / k


# Each method and how the chunk runner runs it: graphed, or eager (eigh).
METHODS = {"eigh": (eigh_project, time_ms), "poly": (psd_project_poly, time_graph_ms),
           "jacobi": (jacobi_project, time_graph_ms)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"))
    ap.add_argument("--max-elems", type=int, default=int(3e7), help="skip points with more entries")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("eig_sweep: torch.cuda.is_available() is False; the sweep times the card")
    dev = resolve_device("cuda")
    dtype = getattr(torch, args.dtype)
    card = card_line()
    out = sweep_path("cuda", args.dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for n in SIZES:
        for b in BATCHES:
            if b * n * n > args.max_elems:
                continue
            m = torch.randn((b, n, n), dtype=dtype, device=dev, generator=gen)
            m = (m + m.transpose(1, 2)) / 2
            row = {"n": n, "batch": b, "dtype": args.dtype, "card": card}
            for name, (fn, timer) in METHODS.items():
                if name != "jacobi" or n <= JACOBI_MAX_N:
                    row[f"{name}_ms"] = timer(fn, m)
            rows.append(row)
            print(json.dumps(row), flush=True)
    with open(out, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(f"wrote {len(rows)} rows to {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
