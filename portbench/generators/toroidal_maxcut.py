"""The max-cut SDP of a 2-D toroidal grid, chordally decomposed.

The graph is rudy's ``-toroidal_grid_2D rows cols``, the command that made
the G-set's toroidal graphs: node ``r * cols + c`` at row r and column c,
joined to its right and lower neighbours with wrap-around, 2 rows cols
edges. Then the frozen ``maxcut_chordal`` (genMAXCUT.m, then ctc). Every
edge weighs 1: genMAXCUT.m takes |W|, so the G-set's signed weights reach
the SDP as 1 all the same. The two parameters define the problem whole;
the seed changes nothing.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from portbench.generators.chordal import maxcut_chordal
from portbench.problem import ProblemArrays


def toroidal_grid(rows: int, cols: int) -> sp.csr_matrix:
    """The symmetric 0/1 adjacency of the rows x cols toroidal grid."""
    if min(rows, cols) < 3:
        raise ValueError("a toroidal grid needs 3 rows and 3 columns or more to have no double edges")
    node = np.arange(rows * cols).reshape(rows, cols)
    src = np.concatenate([node.ravel(), node.ravel()])
    dst = np.concatenate([np.roll(node, -1, axis=1).ravel(), np.roll(node, -1, axis=0).ravel()])
    W = sp.coo_matrix((np.ones(src.size), (src, dst)), shape=(node.size, node.size)).tocsr()
    return (W + W.T).tocsr()


def generate(params: dict, seed: int) -> ProblemArrays:
    rows, cols = int(params["rows"]), int(params["cols"])
    prob, _ = maxcut_chordal(toroidal_grid(rows, cols), name=f"toroidal-maxcut-{rows}x{cols}")
    return prob
