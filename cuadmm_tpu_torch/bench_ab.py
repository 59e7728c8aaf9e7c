"""Benchmark cells of two checkouts in turns on one card.

    python3 -m cuadmm_tpu_torch.bench_ab PARENT CHANGE --cells A,B --seeds S1,S2
        [--seconds 40] [--trace 0] [--out chiprun_out/bench_ab]

Runs ``python3 portbench/run.py --workload <cell> --seed <s> --seconds <t>
--trace <0|1>`` from the root of each checkout, each run in its own
process, so that each side imports its own package. For each cell, the
i-th seed runs on both sides, the parent first where i is even and the
change first where it is odd: two seeds give parent, change, change,
parent, so that a drift of the card over the call cancels out, and the two
sides of a comparison share a seed. Each run's output goes to
``<out>/<side>_<cell>_<seed>.out`` and ``.err``; one JSON line a run
(side, cell, seed, exit code, wall seconds, ``correct`` and the end-to-end
metrics) prints as it ends, and last one line of each side's medians by
cell.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

END_TO_END = ("it_per_s", "setup_s", "peak_mem_gib")


def run_one(root: Path, side: str, cell: str, seed: int, seconds: float, trace: int, out: Path) -> dict:
    """One run of ``cell`` in the checkout at ``root``: its row."""
    stem = out / f"{side}_{cell}_{seed}"
    cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed), "--seconds",
           str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    with open(f"{stem}.out", "w") as so, open(f"{stem}.err", "w") as se:
        rc = subprocess.run(cmd, cwd=root, stdout=so, stderr=se).returncode
    row = dict(side=side, cell=cell, seed=seed, rc=rc, wall_s=time.perf_counter() - t0)
    lines = Path(f"{stem}.out").read_text().strip().splitlines()
    try:
        res = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        res = {}
    metrics = res.get("metrics", {})
    row.update(correct=res.get("correct"),
               **{m: metrics[m]["value"] for m in END_TO_END + ("projection.tri_products_per_it",) if m in metrics})
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="root of the parent's checkout")
    ap.add_argument("change", type=Path, help="root of the change's checkout")
    ap.add_argument("--cells", required=True, help="cells of BENCHMARK.json, comma-separated")
    ap.add_argument("--seeds", required=True, help="seeds, comma-separated; each runs on both sides")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out") / "bench_ab")
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    roots = dict(parent=args.parent.resolve(), change=args.change.resolve())
    rows = []
    for cell in args.cells.split(","):
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            for side in ("parent", "change") if i % 2 == 0 else ("change", "parent"):
                rows.append(run_one(roots[side], side, cell, seed, args.seconds, args.trace, args.out))
    for side in roots:
        medians = {}
        for cell in args.cells.split(","):
            got = [r for r in rows if r["side"] == side and r["cell"] == cell and r["rc"] == 0]
            medians[cell] = {m: statistics.median(r[m] for r in got) for m in END_TO_END
                             if got and all(m in r for r in got)}
        print(json.dumps(dict(side=side, medians=medians)), flush=True)
    return max(r["rc"] for r in rows)


if __name__ == "__main__":
    sys.exit(main())
