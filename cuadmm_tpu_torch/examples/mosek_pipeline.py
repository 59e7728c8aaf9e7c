"""Solve a MOSEK-format problem end to end.

Python counterpart of the reference's MATLAB pipeline
(reference: MATLAB/example_mosek.m:1-66), which chains
MOSEK -> SeDuMi -> SDPT3 -> cuADMM conversions across ~700 lines of
MATLAB utilities (examples/utils/*.m). Here the whole chain is
`load_mosek_mat` (cuadmm_tpu_torch/io/mosek.py).

Run: python -m cuadmm_tpu_torch.examples.mosek_pipeline PATH.mat [--device cuda|cpu]
"""

import argparse
import os

from cuadmm_tpu_torch import SDPSolver, SolverConfig
from cuadmm_tpu_torch.io.mosek import load_mosek_mat


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", nargs="?", help="MOSEK .mat file holding a 'prob' struct")
    parser.add_argument("--device", default="cuda", help="torch device to solve on (cuda or cpu)")
    args = parser.parse_args(argv)
    if args.path is None:
        parser.error("mosek_pipeline needs the path of a MOSEK .mat file (a 'prob' struct)")
    if not os.path.exists(args.path):
        parser.error(f"{args.path} not found")
    prob = load_mosek_mat(args.path)
    print(f"{os.path.basename(args.path)}: {len(prob.blk)} blocks, "
          f"{prob.con_num} constraints, vec_len {prob.vec_len}")

    # Same settings as the MATLAB example: sig=2e2, stop_tol=1e-3, 200 iters.
    cfg = SolverConfig(stop_tol=1e-3, sig=2e2, verbose=True, check_every=50)
    res = SDPSolver(prob, cfg, device=args.device).solve(max_iter=200)
    print(res.message)
    print(f"pobj {res.pobj:.6e}  dobj {res.dobj:.6e}  "
          f"errRp {res.errRp:.2e}  errRd {res.errRd:.2e}")


if __name__ == "__main__":
    main()
