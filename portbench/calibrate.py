"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 --control-seeds 1 2 3

For each seed: the reference's solve of the cell's problem, then one solve
of the program as the cell runs it (the lower readings) and, for the
control seeds, one with the program's float32 state path switched on, the
precision below the configuration's float64 (the upper readings). Each
prints one line: the seed, the program's dtype and ``compare.gaps``.
``--set projection='"eigh"'`` and the like change a setting of both sides,
to look for the cause of a reading.
"""

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                    help="solver settings over the cell's, for both the program and the reference")
    args = ap.parse_args()

    import torch

    from portbench import compare, harness

    wl, cfg, settings = harness.load_cell(harness.manifest(), args.workload)
    settings.update({k: json.loads(v) for k, v in (kv.split("=", 1) for kv in args.set)})
    generator = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    entry = importlib.import_module(f"portbench.entries.{wl['entry']}")
    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    device = torch.device(args.device)
    max_iter, stop_tol = int(wl["max_iter"]), float(settings["stop_tol"])
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        prob = generator.generate(cfg["generator_params"], seed)
        t0 = time.perf_counter()
        ref = reference.Reference(prob, settings, device).solve(max_iter, stop_tol)
        ref_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        dtypes = ([wl["dtype"]] if seed in args.seeds else []) + (["float32"] if seed in args.control_seeds else [])
        for dtype in dtypes:
            t0 = time.perf_counter()
            program = entry.build(prob, dict(settings, dtype=dtype), device)
            res = program.solve(max_iter, stop_tol)
            print(json.dumps(dict(seed=seed, dtype=dtype, **compare.gaps(res, ref), failure=res["failure"],
                                  errRp_last=float(res["info"][-1, 2]), program_s=time.perf_counter() - t0,
                                  reference_s=ref_s, facts=program.facts())), flush=True)
            del program
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
