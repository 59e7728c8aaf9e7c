"""Command-line front end.

Counterpart of the reference executable (reference: src/main.cu:8-44):
``python -m cuadmm_tpu_torch solve <dir>`` loads a TXT problem directory,
runs the solver on ``--device`` (cuda unless the CPU is asked for), and
writes ``X_opt.txt`` next to the inputs (or at --output). Exit code 0 when
the solve converged, 2 when it did not.

Unlike the reference (positional hard-coded arguments), every solver knob
is a flag. Flags, choices and defaults are the JAX package's
(cuadmm_tpu/cli.py), with ``--device`` in place of ``--platform``, so one
command line gives one answer in both packages.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cuadmm_tpu_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("solve", help="solve a TXT problem directory")
    ps.add_argument("dir", help="problem directory containing At.txt, b.txt, C.txt, blk.txt, con_num.txt")
    ps.add_argument("--max-iter", type=int, default=1_000_000)
    ps.add_argument("--stop-tol", type=float, default=1e-3)
    ps.add_argument("--sig", type=float, default=1.0)
    ps.add_argument("--switch-admm", type=int, default=5000,
                    help="iteration at which sGS-ADMM switches to plain ADMM (0 = plain ADMM)")
    ps.add_argument("--dtype", choices=["float32", "float64"], default="float64")
    ps.add_argument(
        "--normal-solver",
        choices=["auto", "precond", "dense", "packed", "split", "cg", "host"],
        default="auto",
    )
    ps.add_argument("--check-every", type=int, default=50)
    ps.add_argument("--warm-start", action="store_true", help="read X.txt/y.txt/S.txt from the directory")
    ps.add_argument("--output", default=None, help="output file (default <dir>/X_opt.txt)")
    ps.add_argument("--device", default="cuda", help="torch device to solve on (cuda or cpu)")
    ps.add_argument("--quiet", action="store_true")

    pi = sub.add_parser("info", help="print problem structure without solving")
    pi.add_argument("dir")

    args = parser.parse_args(argv)

    from cuadmm_tpu_torch.problem import Problem

    if args.cmd == "info":
        from cuadmm_tpu_torch.structure import BlockStructure

        prob = Problem.from_txt(args.dir)
        st = BlockStructure(prob.blk)
        print(f"problem: {prob.name}")
        print(f"  vec_len: {prob.vec_len}")
        print(f"  constraints: {prob.con_num}")
        print(f"  At nnz: {prob.At_nnz}")
        print("  " + st.describe().replace("\n", "\n  "))
        return 0

    from cuadmm_tpu_torch import SDPSolver, SolverConfig
    from cuadmm_tpu_torch.io import txt as txtio

    prob = Problem.from_txt(args.dir, warm_start=args.warm_start)
    cfg = SolverConfig(
        max_iter=args.max_iter,
        stop_tol=args.stop_tol,
        sig=args.sig,
        switch_admm=args.switch_admm,
        dtype=args.dtype,
        normal_solver=args.normal_solver,
        check_every=args.check_every,
        verbose=not args.quiet,
    )
    solver = SDPSolver(prob, cfg, device=args.device)
    res = solver.solve()

    out = args.output or os.path.join(args.dir, "X_opt.txt")
    txtio.write_dense_vector(out, res.X)
    if not args.quiet:
        print(f"wrote {out}")
    return 0 if res.converged else 2


if __name__ == "__main__":
    sys.exit(main())
