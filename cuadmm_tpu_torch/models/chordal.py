"""Chordal decomposition: clique-tree conversion of sparse SDPs.

Counterpart of the reference's MATLAB clique-tree machinery
(reference: examples/max-cut/ctc.m, treeDecomp.m, symbasis.m,
genMAXCUT.m), which reformulates a sparse SDP

    min <C,X>  s.t.  lb <= <A_i,X> <= ub,  X in PSD(n)

as an equivalent SDP over the *cliques* of a chordal completion of the
aggregate sparsity graph: one small PSD block per clique plus equality
constraints tying the clique overlaps together (Zhang & Lavaei,
arXiv:1710.03475; Vandenberghe & Andersen 2015, ch. 10).

Design differences from the reference:
- Pure NumPy/SciPy preprocessing producing a standard multi-block
  ``Problem`` that the TPU solver consumes directly -- the conversion is
  host-side setup, the per-iteration work (many small eighs) is exactly
  what the bucketed batched projection is built for.
- The reference emits SeDuMi-format output with LP/SOCP cones for the
  dualized form (ctc.m:93-149) and never solves it in cuADMM (its solver
  has no l/q cones, README.md block table). Here we emit the primal
  (non-dualized) conversion with inequality slacks as 1x1 PSD blocks,
  which our LP fast path handles natively -- so the converted problem is
  actually solvable end-to-end.
- A positive-semidefinite completion routine recovers Gram vectors of
  the full X from the clique blocks (the reference only stores the data
  "needed for recovery", ctc.m:205-209, with no recovery code).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from cuadmm_tpu_torch.io.conewise import svec_index
from cuadmm_tpu_torch.problem import Problem


# ----------------------------------------------------------------------
# Ordering + tree decomposition
# ----------------------------------------------------------------------


def min_degree_ordering(adj: sp.spmatrix) -> np.ndarray:
    """Greedy minimum-degree elimination ordering.

    Stands in for MATLAB's ``amd`` (reference: ctc.m:50). Set-based
    elimination; O(sum of fill-degree^2), fine for the graph sizes the
    reference targets (power grids, a few thousand nodes).
    """
    n = adj.shape[0]
    A = adj.tocsr()
    nbrs = [set(A.indices[A.indptr[i] : A.indptr[i + 1]]) - {i} for i in range(n)]
    alive = np.ones(n, dtype=bool)
    perm = np.empty(n, dtype=np.int64)
    degs = np.array([len(s) for s in nbrs], dtype=np.int64)
    for k in range(n):
        v = int(np.argmin(np.where(alive, degs, np.iinfo(np.int64).max)))
        perm[k] = v
        alive[v] = False
        live = [w for w in nbrs[v] if alive[w]]
        # Connect the eliminated vertex's neighbors (fill edges).
        for w in live:
            nw = nbrs[w]
            nw.discard(v)
            nw.update(live)
            nw.discard(w)
            degs[w] = len(nw)
        nbrs[v] = set()
    return perm


@dataclasses.dataclass
class CliqueTree:
    """Supernodal clique tree of a chordal completion.

    Mirrors the fields of the reference's ``treeDecomp`` output struct
    (reference: examples/max-cut/treeDecomp.m:10-17, 92-104), with cliques
    in topological (post)order and 0-based vertex labels.
    """

    n: int
    clique: List[np.ndarray]  # sorted original-vertex labels per clique
    parent: np.ndarray  # parent clique index, -1 for roots
    super_: List[np.ndarray]  # clique{v} minus clique{parent(v)}
    isuper: np.ndarray  # vertex -> owning supernode
    perm: np.ndarray  # elimination ordering used

    @property
    def ell(self) -> int:
        return len(self.clique)

    @property
    def nn(self) -> np.ndarray:
        return np.array([len(c) for c in self.clique], dtype=np.int64)

    @property
    def omega(self) -> int:
        return int(self.nn.max()) if self.clique else 0


def tree_decomposition(adj: sp.spmatrix, perm: Optional[np.ndarray] = None) -> CliqueTree:
    """Clique tree of the chordal completion of ``adj`` under ``perm``.

    Reference: examples/max-cut/treeDecomp.m -- symbolic factorization
    columns are the cliques; supernode merge is Vandenberghe-Andersen
    Algorithm 4.1 (treeDecomp.m:107-153).
    """
    n = adj.shape[0]
    if perm is None:
        perm = min_degree_ordering(adj)
    perm = np.asarray(perm, dtype=np.int64)
    pos = np.empty(n, dtype=np.int64)  # vertex -> elimination position
    pos[perm] = np.arange(n)

    # Symbolic elimination in position space: col{k} = {k} + higher
    # neighbors of perm[k] in the filled graph.
    A = adj.tocsr()
    higher = [set() for _ in range(n)]
    for k in range(n):
        v = perm[k]
        for w in A.indices[A.indptr[v] : A.indptr[v + 1]]:
            pw = pos[w]
            if pw > k:
                higher[k].add(int(pw))
    cols: List[np.ndarray] = []
    parent = np.full(n, -1, dtype=np.int64)
    for k in range(n):
        struct = higher[k]
        if struct:
            p = min(struct)
            parent[k] = p
            # Pass fill to the parent column (elimination of k connects
            # its higher neighborhood into a clique rooted at p).
            higher[p].update(struct - {p})
        cols.append(np.array(sorted([k] + list(struct)), dtype=np.int64))

    # Supernode merge (VA Alg 4.1; treeDecomp.m:107-153). Vertices are in
    # elimination order so parent[k] > k already holds.
    children: List[List[int]] = [[] for _ in range(n)]
    for k in range(n):
        if parent[k] >= 0:
            children[parent[k]].append(k)
    deg = np.array([len(c) for c in cols], dtype=np.int64)
    isuper_col = np.full(n, -1, dtype=np.int64)
    sn_parent: List[int] = []
    sn_repre: List[int] = []
    for v in range(n):
        merged_into = -1
        for w in children[v]:
            if deg[w] == deg[v] + 1:
                merged_into = isuper_col[w]
                break
        if merged_into < 0:
            u = len(sn_repre)
            sn_repre.append(v)
            sn_parent.append(-1)
        else:
            u = merged_into
        isuper_col[v] = u
        for w in children[v]:
            z = isuper_col[w]
            if z != u:
                sn_parent[z] = u
    ell = len(sn_repre)
    cliques = [cols[sn_repre[u]] for u in range(ell)]
    sn_parent_arr = np.array(sn_parent, dtype=np.int64)

    # Postorder the supernodal tree (treeDecomp.m:53-77), iteratively.
    ch2: List[List[int]] = [[] for _ in range(ell)]
    roots = []
    for u in range(ell):
        if sn_parent_arr[u] >= 0:
            ch2[sn_parent_arr[u]].append(u)
        else:
            roots.append(u)
    post: List[int] = []
    for r in roots:
        stack = [(r, False)]
        while stack:
            u, expanded = stack.pop()
            if expanded:
                post.append(u)
            else:
                stack.append((u, True))
                for c in reversed(ch2[u]):
                    stack.append((c, False))
    order = np.array(post, dtype=np.int64)
    inv = np.empty(ell, dtype=np.int64)
    inv[order] = np.arange(ell)
    cliques = [cliques[u] for u in order]
    parent2 = np.array(
        [inv[sn_parent_arr[order[i]]] if sn_parent_arr[order[i]] >= 0 else -1 for i in range(ell)],
        dtype=np.int64,
    )

    # super / isuper in original vertex labels (treeDecomp.m:79-90).
    super_: List[np.ndarray] = []
    isuper = np.full(n, -1, dtype=np.int64)
    cliques_orig = [np.sort(perm[c]) for c in cliques]
    for u in range(ell):
        if parent2[u] >= 0:
            s = np.setdiff1d(cliques_orig[u], cliques_orig[parent2[u]], assume_unique=True)
        else:
            s = cliques_orig[u]
        super_.append(s)
        isuper[s] = u
    assert (isuper >= 0).all(), "supernodes must partition the vertices"

    return CliqueTree(
        n=n, clique=cliques_orig, parent=parent2, super_=super_, isuper=isuper, perm=perm
    )


# ----------------------------------------------------------------------
# Clique-tree conversion
# ----------------------------------------------------------------------


def _allocate(T: CliqueTree, M: sp.spmatrix) -> List[Tuple[int, sp.coo_matrix]]:
    """Split one symmetric constraint/cost matrix across cliques.

    Greedy leaf-removal cover, exactly the reference's ``allocate``
    (ctc.m:230-268): visit the supernodes touching M bottom-up; a node is
    included iff M restricted to (clique, super) is still nonzero, in
    which case it absorbs the whole (clique, clique) principal submatrix
    and those entries are zeroed. Returns [(clique_idx, local CSR)].
    """
    M = sp.lil_matrix((M + M.T) / 2.0)
    touched = np.unique(T.isuper[np.unique(sp.coo_matrix(M).row)])
    out: List[Tuple[int, sp.coo_matrix]] = []
    for u in sorted(touched):
        cl, su = T.clique[u], T.super_[u]
        if sp.csr_matrix(M[np.ix_(cl, su)]).nnz > 0:
            sub = sp.coo_matrix(M[np.ix_(cl, cl)])
            out.append((int(u), sub))
            M[np.ix_(cl, cl)] = 0.0
    if sp.csr_matrix(M).nnz > 0:
        raise ValueError(
            "matrix has entries outside the chordal sparsity pattern "
            "(aggregate pattern passed to tree_decomposition must cover it)"
        )
    return out


def _svec_entries(block_off: int, nloc: int, sub: sp.coo_matrix):
    """Local symmetric COO -> global svec (positions, values)."""
    r, c, v = sub.row, sub.col, sub.data
    keep = r >= c
    r, c, v = r[keep], c[keep], v[keep]
    pos = block_off + r * (r + 1) // 2 + c
    vals = np.where(r == c, v, v * np.sqrt(2.0))
    return pos, vals


def objective_svec(T: CliqueTree, offs: np.ndarray, C: sp.spmatrix) -> Tuple[np.ndarray, np.ndarray]:
    """The objective C allocated over the cliques of ``T`` (ctc.m:69), as
    sorted svec (positions, values); ``offs`` are the blocks' svec offsets
    (``CTCInfo.block_offsets``). A problem with another C of the same
    pattern takes the same tree, so its constraints need not be rebuilt."""
    C_pos = [np.empty(0, dtype=np.int64)]
    C_val = [np.empty(0)]
    for u, sub in _allocate(T, sp.csr_matrix(C)):
        p_, v_ = _svec_entries(int(offs[u]), int(T.nn[u]), sub)
        C_pos.append(p_)
        C_val.append(v_)
    pos, val = np.concatenate(C_pos), np.concatenate(C_val)
    srt = np.argsort(pos, kind="stable")
    return pos[srt], val[srt]


@dataclasses.dataclass
class CTCInfo:
    """Recovery data (the reference's ``info`` struct, ctc.m:205-209)."""

    tree: CliqueTree
    block_offsets: np.ndarray  # svec offset of each clique block
    n_overlap: int  # number of overlap-equality constraints
    n_slack: int  # number of LP slack blocks appended


def clique_tree_conversion(
    C: sp.spmatrix,
    A_list: Sequence[sp.spmatrix],
    lb: np.ndarray,
    ub: Optional[np.ndarray] = None,
    tree: Optional[CliqueTree] = None,
    name: str = "ctc",
    eq_tol: float = 1e-8,
) -> Tuple[Problem, CTCInfo]:
    """Convert ``min <C,X> s.t. lb <= <A_i,X> <= ub, X PSD`` to a
    clique-decomposed multi-block ``Problem``.

    Reference: examples/max-cut/ctc.m:1-210 (primal, non-dualized form;
    inequality rows get nonnegative slacks as 1x1 PSD blocks instead of
    the reference's SeDuMi LP cone).
    """
    n = C.shape[0]
    lb = np.asarray(lb, dtype=np.float64).ravel()
    ub = lb.copy() if ub is None else np.asarray(ub, dtype=np.float64).ravel()
    if not (lb <= ub).all():
        raise ValueError("need lb <= ub")
    m = len(A_list)

    if tree is None:
        # Aggregate sparsity pattern (ctc.m:43-47).
        pat = sp.coo_matrix(abs(C))
        for Ai in A_list:
            pat = pat + abs(sp.coo_matrix(Ai))
        pat = (pat + pat.T).tocsr()
        pat.data[:] = 1.0
        tree = tree_decomposition(pat)
    T = tree

    nn = T.nn
    ell = T.ell
    offs = np.zeros(ell + 1, dtype=np.int64)
    offs[1:] = np.cumsum(nn * (nn + 1) // 2)
    sdp_len = int(offs[-1])

    is_eq = (ub - lb) < eq_tol
    has_lb = np.isfinite(lb) & ~is_eq
    has_ub = np.isfinite(ub) & ~is_eq
    n_slack = int(has_lb.sum() + has_ub.sum())
    vec_len = sdp_len + n_slack

    at_rows: List[np.ndarray] = []
    at_cols: List[np.ndarray] = []
    at_vals: List[np.ndarray] = []
    b_rows: List[int] = []
    b_vals: List[float] = []

    con = 0
    slack = 0

    def add_row(pos: np.ndarray, vals: np.ndarray, rhs: float) -> None:
        nonlocal con
        at_rows.append(pos.astype(np.int64))
        at_cols.append(np.full(len(pos), con, dtype=np.int64))
        at_vals.append(vals)
        if rhs != 0.0:
            b_rows.append(con)
            b_vals.append(rhs)
        con += 1

    # Original constraints, allocated over cliques (ctc.m:71-73).
    for i in range(m):
        pieces = _allocate(T, sp.csr_matrix(A_list[i]))
        pos = [np.empty(0, dtype=np.int64)]
        vals = [np.empty(0)]
        for u, sub in pieces:
            p, v = _svec_entries(int(offs[u]), int(nn[u]), sub)
            pos.append(p)
            vals.append(v)
        pos_i = np.concatenate(pos)
        vals_i = np.concatenate(vals)
        if is_eq[i]:
            add_row(pos_i, vals_i, 0.5 * (lb[i] + ub[i]))
        else:
            # <A_i,X> - s_lb = lb (s_lb >= 0); <A_i,X> + s_ub = ub.
            if has_lb[i]:
                sp_pos = np.append(pos_i, sdp_len + slack)
                sp_val = np.append(vals_i, -1.0)
                slack += 1
                add_row(sp_pos, sp_val, lb[i])
            if has_ub[i]:
                sp_pos = np.append(pos_i, sdp_len + slack)
                sp_val = np.append(vals_i, 1.0)
                slack += 1
                add_row(sp_pos, sp_val, ub[i])

    # Overlap (consistency) constraints (ctc.m:319-350): for each
    # non-root clique v and each pair (a<=b) in clique_v n clique_parent,
    # X_v[a,b] - X_p[a,b] = 0.
    n_overlap = 0
    for v in range(ell):
        p = int(T.parent[v])
        if p < 0:
            continue
        inter = np.intersect1d(T.clique[v], T.clique[p], assume_unique=True)
        loc_v = np.searchsorted(T.clique[v], inter)
        loc_p = np.searchsorted(T.clique[p], inter)
        k = len(inter)
        ii, jj = np.tril_indices(k)
        pos_v = offs[v] + loc_v[ii] * (loc_v[ii] + 1) // 2 + loc_v[jj]
        # Parent-local indices of the pair, ordered (row >= col).
        pr = np.maximum(loc_p[ii], loc_p[jj])
        pc = np.minimum(loc_p[ii], loc_p[jj])
        pos_p = offs[p] + pr * (pr + 1) // 2 + pc
        ones = np.ones(len(ii))
        for q_v, q_p in zip(pos_v, pos_p):
            add_row(np.array([q_v, q_p]), np.array([1.0, -1.0]), 0.0)
        n_overlap += len(ii)

    C_pos_arr, C_val_arr = objective_svec(T, offs, C)

    rows = np.concatenate(at_rows)
    cols = np.concatenate(at_cols)
    vals = np.concatenate(at_vals)
    srt = np.lexsort((rows, cols))  # constraint-major, as from_txt produces
    blk: List[Tuple[str, int]] = [("s", int(sz)) for sz in nn]
    blk += [("s", 1)] * n_slack

    prob = Problem(
        blk=blk,
        con_num=con,
        At_rows=rows[srt].astype(np.int32),
        At_cols=cols[srt].astype(np.int32),
        At_vals=vals[srt],
        b_indices=np.array(b_rows, dtype=np.int32),
        b_vals=np.array(b_vals, dtype=np.float64),
        C_indices=C_pos_arr.astype(np.int32),
        C_vals=C_val_arr,
        name=name,
    )
    info = CTCInfo(tree=T, block_offsets=offs, n_overlap=n_overlap, n_slack=n_slack)
    return prob, info


# ----------------------------------------------------------------------
# Recovery: entries of X + PSD completion
# ----------------------------------------------------------------------


def extract_entries(info: CTCInfo, X_svec: np.ndarray) -> sp.csr_matrix:
    """Read the entries of the original X on the chordal pattern out of the
    clique blocks (consistent by the overlap constraints; averaged where
    cliques overlap for robustness to solver tolerance)."""
    T = info.tree
    n = T.n
    acc = sp.lil_matrix((n, n))
    cnt = sp.lil_matrix((n, n))
    for u in range(T.ell):
        cl = T.clique[u]
        k = len(cl)
        ii, jj = np.tril_indices(k)
        pos = info.block_offsets[u] + ii * (ii + 1) // 2 + jj
        vals = X_svec[pos] * np.where(ii == jj, 1.0, 1.0 / np.sqrt(2.0))
        for a, b, v in zip(cl[ii], cl[jj], vals):
            acc[a, b] += v
            cnt[a, b] += 1.0
    acc = acc.tocsr()
    cnt = cnt.tocsr()
    acc.data /= cnt.data
    out = acc + sp.triu(acc.T, 1)
    return out.tocsr()


def complete_gram_vectors(info: CTCInfo, X_svec: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """PSD completion: Gram vectors V (n x n) with (V V^T)[i,j] matching the
    clique blocks on the chordal pattern (Vandenberghe-Andersen ch. 10).

    Processed root-first down the clique tree: each clique's new vertices
    get vectors matching the block's cross-covariance with the already-
    placed separator vectors plus a Schur-complement residual in fresh
    orthogonal directions. Enables Goemans-Williamson rounding on
    clique-decomposed max-cut solutions.
    """
    T = info.tree
    n = T.n
    V = np.zeros((n, n))
    placed = np.zeros(n, dtype=bool)

    def block_of(u: int) -> np.ndarray:
        cl = T.clique[u]
        k = len(cl)
        ii, jj = np.tril_indices(k)
        pos = info.block_offsets[u] + ii * (ii + 1) // 2 + jj
        M = np.zeros((k, k))
        M[ii, jj] = X_svec[pos] * np.where(ii == jj, 1.0, 1.0 / np.sqrt(2.0))
        return M + np.tril(M, -1).T

    # Root-first = reverse postorder (parents precede children).
    for u in reversed(range(T.ell)):
        cl = T.clique[u]
        M = block_of(u)
        new = ~placed[cl]
        S_idx = np.where(~new)[0]
        U_idx = np.where(new)[0]
        if len(U_idx) == 0:
            continue
        if len(S_idx) == 0:
            w, Q = np.linalg.eigh(M)
            V[cl, : len(cl)] = Q * np.sqrt(np.maximum(w, 0.0))
        else:
            Vs = V[cl[S_idx]]  # (|S|, n)
            Xus = M[np.ix_(U_idx, S_idx)]
            Xss = M[np.ix_(S_idx, S_idx)]
            Xuu = M[np.ix_(U_idx, U_idx)]
            Xss_pinv = np.linalg.pinv(Xss, rcond=eps)
            Vu = Xus @ Xss_pinv @ Vs
            R = Xuu - Xus @ Xss_pinv @ Xus.T
            w, Q = np.linalg.eigh((R + R.T) / 2.0)
            F = Q * np.sqrt(np.maximum(w, 0.0))
            # Residual directions orthogonal to span(Vs): project out.
            basis = np.linalg.svd(Vs, full_matrices=True)[2]
            rank_s = np.linalg.matrix_rank(Vs, tol=1e-8)
            ortho = basis[rank_s:]
            k_res = min(F.shape[1], ortho.shape[0])
            V[cl[U_idx]] = Vu + F[:, :k_res] @ ortho[:k_res]
        placed[cl] = True
    return V


# ----------------------------------------------------------------------
# Max-cut front end (genMAXCUT.m + ctc.m pipeline)
# ----------------------------------------------------------------------


def _maxcut_graph(W, signed: bool) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """(the edge weights the objective takes, the graph's 0/1 pattern): W
    symmetrised with its diagonal dropped, as |W| (genMAXCUT.m) or with
    its signs (``signed``); the pattern is that of |W|, whatever the signs."""
    Wm = sp.csr_matrix(W, dtype=np.float64)
    absW = (abs(Wm) + abs(Wm).T) / 2.0
    absW.setdiag(0.0)
    absW.eliminate_zeros()
    pattern = absW.copy()
    pattern.data[:] = 1.0
    if not signed:
        return absW, pattern
    Ws = ((Wm + Wm.T) / 2.0).tocsr()
    Ws.setdiag(0.0)
    Ws.eliminate_zeros()
    return Ws, pattern


def _maxcut_objective(Wm: sp.spmatrix, k: int) -> sp.spmatrix:
    """C = -(k-1)/(2k) (Diag(W e) - W), the weighted Laplacian's multiple."""
    deg = np.asarray(Wm.sum(axis=1)).ravel()
    return (-(k - 1) / (2.0 * k)) * (sp.diags(deg) - Wm)


def maxcut_chordal(
    W: np.ndarray | sp.spmatrix, k: int = 2, name: str = "maxcut-ctc", signed: bool = False
) -> Tuple[Problem, CTCInfo]:
    """Chordally-decomposed max-k-cut SDP relaxation.

    Reference: examples/max-cut/genMAXCUT.m (problem data; k=2 gives the
    Goemans-Williamson relaxation with the same -L/4 objective as
    ``maxcut_sdp``) piped through ctc (run_maxcut.m:11-12).

    genMAXCUT.m takes |W|. ``signed`` keeps W's signs in the objective,
    C = -(k-1)/(2k) (Diag(W e) - W) with W symmetrised: the max-cut of a
    graph with negative weights, such as a +-J spin glass, which under |W|
    becomes another problem. The tree decomposition and the constraints
    depend only on the graph's pattern (plus the diagonal) either way.
    """
    if k < 2 or k != int(k):
        raise ValueError("meaningless choice of k")
    Wm, pattern = _maxcut_graph(W, signed)
    n = Wm.shape[0]
    C = _maxcut_objective(Wm, k)

    A_list: List[sp.spmatrix] = [
        sp.coo_matrix(([1.0], ([i], [i])), shape=(n, n)) for i in range(n)
    ]
    lb = [1.0] * n
    ub = [1.0] * n
    if k > 2:
        # Edge constraints X_ij >= -1/(k-1) (genMAXCUT.m:33-42, stated as
        # 2 X_ij >= -2/(k-1) with both triangles carrying coefficient 1).
        Wl = sp.tril(pattern, -1).tocoo()
        for i, j in zip(Wl.row, Wl.col):
            A_list.append(
                sp.coo_matrix(([1.0, 1.0], ([i, j], [j, i])), shape=(n, n))
            )
            lb.append(-2.0 / (k - 1))
            ub.append(np.inf)

    # Aggregate pattern = graph + diagonal (the objective covers it).
    pat = (pattern + sp.eye(n)).tocsr()
    pat.data[:] = 1.0
    tree = tree_decomposition(pat)
    return clique_tree_conversion(
        C, A_list, np.array(lb), np.array(ub), tree=tree, name=name
    )


def maxcut_chordal_family(
    Ws: Sequence[np.ndarray | sp.spmatrix], k: int = 2, name: str = "maxcut-ctc", signed: bool = False
) -> Tuple[List[Problem], CTCInfo]:
    """``maxcut_chordal`` of each graph in ``Ws``, from one tree
    decomposition: the instances of a family whose graphs share their
    pattern and differ in their weights (disorder realizations of one
    lattice). The first is converted whole; the others share its blk and
    constraint arrays (the same objects, so A is bitwise equal, as
    ``BatchedSDPSolver`` needs) and take only their own objective
    (``objective_svec``). Raises ValueError if the patterns differ."""
    if not len(Ws):
        raise ValueError("empty family")
    base, info = maxcut_chordal(Ws[0], k, name=f"{name}-0", signed=signed)
    pattern0 = _maxcut_graph(Ws[0], signed)[1]
    probs = [base]
    for i, W in enumerate(Ws[1:], 1):
        Wm, pattern = _maxcut_graph(W, signed)
        if pattern.shape != pattern0.shape or (pattern != pattern0).nnz:
            raise ValueError(f"instance {i}'s graph has another pattern than instance 0's")
        pos, vals = objective_svec(info.tree, info.block_offsets, _maxcut_objective(Wm, k))
        probs.append(dataclasses.replace(base, C_indices=pos.astype(np.int32), C_vals=vals, name=f"{name}-{i}"))
    return probs, info
