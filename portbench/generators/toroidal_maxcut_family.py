"""A family of +-J spin glasses on one 2-D torus: the signed max-cut SDP of
each disorder realization, chordally decomposed on one clique tree.

The graph is rudy's ``-toroidal_grid_2D rows cols`` (``toroidal_grid``);
each instance gives every edge its own weight, +1 or -1 with equal odds,
drawn from the seed as rudy's ``-random 0 1 <seed> -times 2 -plus -1`` draws
G11's (by numpy, not rudy's generator). The SDP is genMAXCUT.m with the
weights' signs kept, C = -(1/4) (Diag(W e) - W), then ctc: the tree
decomposition of the graph's pattern plus the diagonal, the same for every
instance, so every instance has the same blocks and constraints (the frozen
``tree_decomposition`` and ``clique_tree_conversion``) and only its own C
(``objective_svec``). With the weights' absolute values instead, every
instance of a bipartite torus would be the same trivial cut.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp

from portbench.generators.chordal import clique_tree_conversion, objective_svec, tree_decomposition
from portbench.generators.toroidal_maxcut import toroidal_grid
from portbench.problem import ProblemArrays


@dataclasses.dataclass
class FamilyArrays(ProblemArrays):
    """The instances' shared arrays, with instance 0's C, and every
    instance's C as svec (positions, values) in ``objectives``."""

    objectives: List[Tuple[np.ndarray, np.ndarray]] = dataclasses.field(default_factory=list)

    def instance(self, i: int) -> ProblemArrays:
        """Instance ``i`` as a plain problem: the shared arrays and its C."""
        fields = {f.name: getattr(self, f.name) for f in dataclasses.fields(ProblemArrays)}
        pos, vals = self.objectives[i]
        return ProblemArrays(**dict(fields, C_indices=pos, C_vals=vals, name=f"{self.name}-{i}"))


def signed_weights(G: sp.spmatrix, instances: int, seed: int) -> List[sp.csr_matrix]:
    """``instances`` symmetric weightings of the graph ``G``: each edge +1 or
    -1 with equal odds, all drawn from ``seed``."""
    edges = sp.triu(G, 1).tocoo()
    signs = np.random.default_rng(seed).choice([-1.0, 1.0], size=(instances, edges.nnz))
    out = []
    for s in signs:
        W = sp.coo_matrix((s, (edges.row, edges.col)), shape=G.shape).tocsr()
        out.append((W + W.T).tocsr())
    return out


def signed_objective(W: sp.spmatrix) -> sp.spmatrix:
    """genMAXCUT.m's C at k = 2 with W's signs kept: -(1/4) (Diag(W e) - W)."""
    return -0.25 * (sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W)


def generate(params: dict, seed: int) -> FamilyArrays:
    rows, cols, instances = int(params["rows"]), int(params["cols"]), int(params["instances"])
    G = toroidal_grid(rows, cols)
    n = G.shape[0]
    pat = (G + sp.eye(n)).tocsr()
    pat.data[:] = 1.0
    tree = tree_decomposition(pat)
    diag = [sp.coo_matrix(([1.0], ([i], [i])), shape=(n, n)) for i in range(n)]
    objectives = []
    base = None
    for W in signed_weights(G, instances, seed):
        C = signed_objective(W)
        if base is None:
            base, info = clique_tree_conversion(C, diag, np.ones(n), np.ones(n), tree=tree,
                                                name=f"toroidal-pm-j-{rows}x{cols}")
            objectives.append((base.C_indices, base.C_vals))
            continue
        pos, vals = objective_svec(info.tree, info.block_offsets, C)
        objectives.append((pos.astype(np.int32), vals))
    fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(ProblemArrays)}
    return FamilyArrays(**fields, objectives=objectives)
