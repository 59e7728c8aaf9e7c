"""Max-cut SDP relaxation: dense and chordal-decomposed.

Python counterpart of the reference's max-cut generator + clique-tree
conversion pipeline (reference: examples/max-cut/run_maxcut.m:1-23,
genMAXCUT.m, ctc.m, treeDecomp.m), including the PSD completion step the
reference leaves to the user.

Run: python -m cuadmm_tpu_torch.examples.maxcut_demo [--device cuda|cpu]
"""

import argparse

from cuadmm_tpu_torch import SDPSolver, SolverConfig
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.maxcut import maxcut_sdp, random_graph, round_solution


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device to solve on (cuda or cpu)")
    args = parser.parse_args(argv)

    W = random_graph(40, p=0.15, seed=1)
    cfg = SolverConfig(stop_tol=1e-4, verbose=False, check_every=100)

    # Dense relaxation: one 40x40 block.
    prob = maxcut_sdp(W)
    res = SDPSolver(prob, cfg, device=args.device).solve(max_iter=20000)
    cut = round_solution(W, res.X)
    print(f"dense:   {res.message.strip()} pobj={res.pobj:.4f} cut={cut:.4f}")

    # Chordal decomposition: clique blocks + overlap constraints.
    cprob, meta = maxcut_chordal(W)
    cres = SDPSolver(cprob, cfg, device=args.device).solve(max_iter=20000)
    sizes = [n for _, n in cprob.blk]
    print(f"chordal: {cres.message.strip()} pobj={cres.pobj:.4f} "
          f"({len(sizes)} cliques, max size {max(sizes)})")
    assert abs(res.pobj - cres.pobj) < 1e-2 * (1 + abs(res.pobj))


if __name__ == "__main__":
    main()
