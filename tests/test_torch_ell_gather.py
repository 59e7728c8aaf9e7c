"""The bucketed-ELL product kernel (csrc/ell_products.cu) and its wrapper
in ops/sparse.py.

On the CPU the products run their plain versions, bit for bit as before
the kernel, and launch nothing; the kernel's bucket descriptors are
checked on tables shaped as the benchmark's G11 and QUASAR ones, and a
model of the kernel's element map that reads the tables through the
descriptors' pointers is held to the plain version. The kernel itself runs
only on a card: those tests are marked ``cuda`` and run with
``python -m pytest --noconftest -m cuda tests/test_torch_ell_gather.py``
(the suite's conftest imports jax, which the card's machine lacks).
"""

import ctypes

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch.config import SolverConfig
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.quasar import quasar_constraints
from cuadmm_tpu_torch.ops import sparse
from cuadmm_tpu_torch.structure import BlockStructure
from cuadmm_tpu_torch.trace import COUNTS
from portbench.generators.toroidal_maxcut import toroidal_grid

torch.set_num_threads(1)

REL_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}  # sums in another order
# Entries of the synthetic constraints: three empty, enough of each small
# count for a bucket of its own (the build merges buckets of fewer than 256
# rows upward), and one each of the wide ones.
ENTRIES = (0,) * 3 + (1, 2, 3, 5, 8, 17) * 300 + (33, 100, 513, 2048)


def _solver_tables(blk, rows, cols, vals, con_num, dtype=torch.float64, device="cpu"):
    """A's tables as the solver builds them (solver/driver.py, init.ell_tables):
    an f32 table is the device cast of the f64 one."""
    cfg = SolverConfig()
    st = BlockStructure(blk, cfg.bucket_rounding, cfg.exact_above, 0)
    _, at_vals = sparse.normalize_rows(rows, cols, vals, con_num)
    return sparse.build_sparse_a_pool(rows, cols, at_vals, con_num, st, (torch.float64, dtype), device)[-1]


def _g11(device="cpu", dtype=torch.float64):
    """G11's torus through the max-cut pipeline: the tables of the
    benchmark's gset_g11_chordal and gset_g11_weighted cells."""
    prob, _ = maxcut_chordal(toroidal_grid(100, 8))
    return _solver_tables(prob.blk, prob.At_rows, prob.At_cols, prob.At_vals, prob.con_num, dtype, device)


def _quasar(n_poses=20, device="cpu", dtype=torch.float64):
    """QUASAR's constraints at a small N: A's widths 2 and one trace row,
    A^T's 1, 2 and the wide diagonal slots, as at N = 500."""
    rows, cols, vals, con, n = quasar_constraints(n_poses)
    return _solver_tables([("s", n)], rows, cols, vals, con, dtype, device)


def _synthetic(kind, device="cpu", dtype=torch.float64, seed=3):
    """Constraints of ENTRIES entries, one of which, svec entry 0, every
    non-empty constraint shares (a wide A^T row). "perm": one 70 block,
    which A^T writes almost whole (out_perm). "pos": a second, untouched
    200 block beside it, so A^T's output is mostly zero (out_pos) and
    aat_matvec composes compactly."""
    rng = np.random.default_rng(seed)
    blk = [("s", 70)] + ([("s", 200)] if kind == "pos" else [])
    touch = 70 * 71 // 2
    rows, cols = [], []
    for c, w in enumerate(ENTRIES):
        if w:
            rows.append(np.concatenate([[0], rng.choice(np.arange(1, touch), size=w - 1, replace=False)]))
            cols.append(np.full(w, c))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    sa = sparse.build_sparse_a_pool(rows, cols, rng.standard_normal(len(rows)), len(ENTRIES),
                                    BlockStructure(blk, "pow2", 64, 0), (torch.float64, dtype), device)[-1]
    assert (sa.at.out_pos is not None) == (kind == "pos") and (sa.a_idx_compact is not None) == (kind == "pos")
    return sa


@pytest.fixture(scope="module")
def g11():
    return _g11()


def _model(desc, dtype, in_len, x, src, dst, n_elem, out_len):
    """The kernel's element map in numpy, reading the buckets through the
    descriptors' pointers (CPU tensors): row(e) = src[e] or e, a row past
    the last bucket zero, padding (index in_len) skipped, out[at(e)]."""
    nb = (len(desc) - 1) // 4
    off, ptrs_i = desc[: nb + 1], desc[nb + 1: 2 * nb + 1]
    ptrs_v, widths = desc[2 * nb + 1: 3 * nb + 1], desc[3 * nb + 1:]
    ctype = ctypes.c_double if dtype == torch.float64 else ctypes.c_float
    buckets = []
    for k in range(nb):
        n = int(off[k + 1] - off[k]) * int(widths[k])
        ii = np.ctypeslib.as_array(ctypes.cast(int(ptrs_i[k]), ctypes.POINTER(ctypes.c_int64)), (n,))
        vv = np.ctypeslib.as_array(ctypes.cast(int(ptrs_v[k]), ctypes.POINTER(ctype)), (n,))
        buckets.append((ii.reshape(-1, widths[k]).copy(), vv.reshape(-1, widths[k]).astype(np.float64)))
    xs = x.reshape(-1, in_len).double().numpy()
    out = np.zeros((xs.shape[0], out_len))
    for e in range(n_elem):
        row = int(src[e]) if src is not None else e
        at = int(dst[e]) if dst is not None else e
        k = int(np.searchsorted(off, row, side="right")) - 1
        if 0 <= k < nb:
            ii, vv = buckets[k][0][row - off[k]], buckets[k][1][row - off[k]]
            keep = ii < in_len
            out[:, at] = xs[:, ii[keep]] @ vv[keep]
    return out.reshape(tuple(x.shape[:-1]) + (out_len,))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# ----------------------------------------------------------------------
# CPU: the plain path, the descriptors, the wrapper's checks
# ----------------------------------------------------------------------


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("kind", ["perm", "pos"])
def test_cpu_tensors_launch_nothing_and_take_the_plain_path(kind, lead):
    sa = _synthetic(kind)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(lead + (sa.vec_len,)))
    y = torch.as_tensor(rng.standard_normal(lead + (sa.con_num,)))
    before = COUNTS["ell"]
    assert torch.equal(sparse.spmv_a(sa, x), sparse._ell_matvec_ref(sa.a, x))
    assert torch.equal(sparse.spmv_at(sa, y), sparse._ell_matvec_ref(sa.at, y))
    want = (sparse._aat_compact_ref(sa, y) if kind == "pos"
            else sparse._ell_matvec_ref(sa.a, sparse._ell_matvec_ref(sa.at, y)))
    assert torch.equal(sparse.aat_matvec(sa, y), want)
    assert COUNTS["ell"] == before


def _check_desc(t, idx=None, vals=None, desc=None):
    idx = t.idx if idx is None else idx
    vals = t.vals if vals is None else vals
    desc = t.launch_desc if desc is None else desc
    nb = len(idx)
    assert desc.dtype == np.int64 and desc.shape == (4 * nb + 1,)
    rows = [i.shape[0] for i in idx]
    np.testing.assert_array_equal(desc[: nb + 1], np.concatenate([[0], np.cumsum(rows)]))
    assert list(desc[nb + 1: 2 * nb + 1]) == [i.data_ptr() for i in idx]
    assert list(desc[2 * nb + 1: 3 * nb + 1]) == [v.data_ptr() for v in vals]
    assert list(desc[3 * nb + 1:]) == [i.shape[1] for i in idx]
    assert nb <= sparse.MAX_BUCKETS
    return int(desc[nb])


@pytest.mark.parametrize("which", ["g11", "quasar"])
def test_descriptors_of_the_benchmark_shaped_tables(which, request):
    """G11's and QUASAR's tables: the descriptors name every bucket's rows,
    width and tensors; padding is index in_len; out_perm's sentinel is the
    total of rows, where the kernel sums nothing; both place by out_perm,
    so aat_matvec composes spmv_a and spmv_at."""
    sa = request.getfixturevalue("g11") if which == "g11" else _quasar()
    widths = {"g11": ([1, 2], [1, 2, 4, 8]), "quasar": ([2, 128], [1, 2, 32])}[which]
    for t, want in zip((sa.a, sa.at), widths):
        total = _check_desc(t)
        assert [i.shape[1] for i in t.idx] == want
        assert t.out_perm is not None and t.out_pos is None
        perm = t.out_perm.numpy()
        assert perm.max() <= total and (perm == total).sum() == t.out_len - len(np.unique(perm[perm < total]))
        for i, v in zip(t.idx, t.vals):
            pad = i.numpy() == t.in_len
            assert np.all(v.numpy()[pad] == 0) and np.all(i.numpy()[~pad] < t.in_len)
        assert t.launch_desc is t.launch_desc  # made once
    assert sa.a_idx_compact is None
    f32 = sparse.cast_sparse_a(sa, torch.float32)
    _check_desc(f32.a)
    assert list(f32.a.launch_desc[:len(sa.a.idx) + 1]) == list(sa.a.launch_desc[:len(sa.a.idx) + 1])


def test_descriptors_of_the_scatter_and_compact_encodings():
    sa = _synthetic("pos")
    n_cat = _check_desc(sa.at)
    assert sa.at.out_pos is not None and sa.at.out_perm is None
    assert int(sa.at.out_src.max()) < n_cat and len(sa.at.out_pos) == n_cat
    _check_desc(sa.a, sa.a_idx_compact, sa.a.vals, sa.compact_desc)
    assert max(int(i.max()) for i in sa.a_idx_compact) == n_cat  # the compact sentinel
    assert sa.compact_desc is sa.compact_desc


@pytest.mark.parametrize("lead", [(), (2,)])
@pytest.mark.parametrize("which", ["g11", "quasar", "perm", "pos"])
def test_kernel_element_map_matches_plain(which, lead, request):
    """The kernel's map (``_model``, through the descriptors' pointers)
    gives the plain products: A x, A^T y in either placement, and the
    compact AA^T y's two halves."""
    sa = {"g11": lambda: request.getfixturevalue("g11"), "quasar": _quasar,
          "perm": lambda: _synthetic("perm"), "pos": lambda: _synthetic("pos")}[which]()
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal(lead + (sa.vec_len,)))
    y = torch.as_tensor(rng.standard_normal(lead + (sa.con_num,)))
    for t, v in ((sa.a, x), (sa.at, y)):
        if t.out_pos is not None:
            got = _model(t.launch_desc, v.dtype, t.in_len, v, t.out_src, t.out_pos, len(t.out_pos), t.out_len)
        else:
            got = _model(t.launch_desc, v.dtype, t.in_len, v, t.out_perm, None, t.out_len, t.out_len)
        assert _rel(got, sparse._ell_matvec_ref(t, v)) < 1e-14
    if sa.a_idx_compact is not None:
        n_cat = int(sa.at.launch_desc[len(sa.at.idx)])
        cat = torch.as_tensor(_model(sa.at.launch_desc, y.dtype, sa.at.in_len, y, None, None, n_cat, n_cat))
        got = _model(sa.compact_desc, y.dtype, n_cat, cat, sa.a.out_perm, None, sa.a.out_len, sa.a.out_len)
        assert _rel(got, sparse._aat_compact_ref(sa, y)) < 1e-14


@pytest.mark.parametrize(
    "x_shape,x_dtype,err",
    [
        ((41,), torch.float64, ValueError),  # the wrong length
        ((), torch.float64, ValueError),  # no axis
        ((4, 41), torch.float64, ValueError),
        (None, torch.float32, TypeError),  # not the table's dtype
        (None, torch.float16, TypeError),
        (None, torch.float64, ValueError),  # a CPU tensor: the kernel takes CUDA tensors
    ],
    ids=["length", "scalar", "lead_length", "f32_for_f64", "f16", "cpu"],
)
def test_wrapper_rejects(x_shape, x_dtype, err):
    sa = _synthetic("perm")
    t = sa.a
    x = torch.zeros(x_shape if x_shape is not None else (t.in_len,), dtype=x_dtype)
    before = COUNTS["ell"]
    with pytest.raises(err):
        sparse._gather(t.launch_desc, t.vals, t.in_len, x, t.out_perm, None, t.out_len, t.out_len)
    assert COUNTS["ell"] == before


def test_wrapper_rejects_more_buckets_than_the_kernel_takes():
    desc = np.zeros(4 * (sparse.MAX_BUCKETS + 1) + 1, np.int64)
    x = torch.zeros(5, dtype=torch.float64, device="meta")
    vals = (torch.zeros(1, 1, dtype=torch.float64, device="meta"),)
    with pytest.raises(ValueError, match="buckets"):
        sparse._gather(desc, vals, 5, x, None, None, 1, 1)


def test_plain_batch_is_the_stacked_rows_bit_for_bit():
    """Leading instance axes: each instance's product is the single one."""
    sa = _quasar()
    y = torch.as_tensor(np.random.default_rng(6).standard_normal((4, sa.con_num)))
    got = sparse.aat_matvec(sa, y)
    assert torch.equal(got, torch.stack([sparse.aat_matvec(sa, row) for row in y]))


# ----------------------------------------------------------------------
# The card
# ----------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


def _card_case(which, dtype):
    if which in ("perm", "pos"):
        return _synthetic(which, "cuda", dtype)
    return _g11("cuda", dtype) if which == "g11" else _quasar(20, "cuda", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("lead", [(), (8,)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("which", ["perm", "pos", "g11", "quasar"])
def test_kernel_matches_plain_on_card(which, dtype, lead):
    """spmv_a, spmv_at (out_perm or out_pos) and aat_matvec (composed, or
    compact in "pos") against the plain versions on the same card tensors:
    empty rows, sentinel slots and widths 1 to 2,048; one launch a product,
    two an aat_matvec."""
    _needs_card()
    sa = _card_case(which, dtype)
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal(lead + (sa.vec_len,)), dtype=dtype, device="cuda")
    y = torch.as_tensor(rng.standard_normal(lead + (sa.con_num,)), dtype=dtype, device="cuda")
    for fn, ref, v, launches in (
        (sparse.spmv_a, lambda s, v: sparse._ell_matvec_ref(s.a, v), x, 1),
        (sparse.spmv_at, lambda s, v: sparse._ell_matvec_ref(s.at, v), y, 1),
        (sparse.aat_matvec, lambda s, v: (sparse._aat_compact_ref(s, v) if s.a_idx_compact is not None
                                          else sparse._ell_matvec_ref(s.a, sparse._ell_matvec_ref(s.at, v))), y, 2),
    ):
        before = COUNTS["ell"]
        got = fn(sa, v)
        torch.cuda.synchronize()
        assert COUNTS["ell"] == before + launches
        want = ref(sa, v)
        assert got.shape == want.shape and got.dtype == dtype
        assert _rel(got.cpu(), want.cpu()) < REL_TOL[dtype], fn.__name__
        assert torch.equal(fn(sa, v), got), f"{fn.__name__}: two launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["perm", "pos"])
def test_graph_replay_is_the_eager_result_bitwise_on_card(which):
    _needs_card()
    sa = _synthetic(which, "cuda")
    y = torch.as_tensor(np.random.default_rng(8).standard_normal((8, sa.con_num)), device="cuda")
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(sa.vec_len), device="cuda")
    eager = (sparse.aat_matvec(sa, y), sparse.spmv_at(sa, y), sparse.spmv_a(sa, x))
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sparse.aat_matvec(sa, y)  # warm the allocator on the side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = (sparse.aat_matvec(sa, y), sparse.spmv_at(sa, y), sparse.spmv_a(sa, x))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)
