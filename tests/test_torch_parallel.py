"""The port's several-devices path against cuadmm_tpu on a device mesh.

Counterparts of tests/test_parallel.py's nine tests, plus the launcher,
``auto`` over a mesh, the ranks' bitwise agreement and the batched solver
over a mesh. The port runs 2 and 4 gloo ranks on the CPU, started by
``parallel.launch.run_ranks``; the JAX package runs the same inputs on
``make_mesh(2)`` / ``make_mesh(4)`` of the conftest's virtual devices (or
on one device where its own test compares a mesh with one device).

Every check of one world size runs in one spawn (``rank_jobs.run_checks``),
computed once per module; the ranks import the port's ``rank_jobs``,
never this file or jax. Tolerances are stated at each comparison. JAX is
imported inside the fixtures and tests that compare with it, so the
card-only test at the end runs with ``--noconftest`` on a machine without
jax.
"""

import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cuadmm_tpu_torch
from cuadmm_tpu_torch.models.random_sdp import _svec
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp as t_certified
from cuadmm_tpu_torch.ops import chol as tchol
from cuadmm_tpu_torch.parallel import rank_jobs
from cuadmm_tpu_torch.parallel.dryrun import dryrun_job
from cuadmm_tpu_torch.parallel.launch import run_ranks
from cuadmm_tpu_torch.parallel.mesh import Mesh, shard_bounds
from cuadmm_tpu_torch.structure import BlockStructure

torch.set_num_threads(1)

WORLDS = (2, 4)
TIMEOUT_S = 240.0  # one world's spawn of every check
CPU = torch.device("cpu")

PROJ_BLK = [("s", 5)] * 16 + [("s", 3)] * 8  # tests/test_parallel.py:28
PACKED_BLK = [("s", 3), ("s", 2), ("s", 5), ("s", 1)] * 8 + [("u", 3)]
FULL_CFG = dict(verbose=False, check_every=25, switch_admm=10**9, normal_solver="dense", projection="eigh",
                precond_applies=2)
SCALE_CFG = dict(FULL_CFG, check_every=50)
SHARDED_CFG = dict(verbose=False, check_every=100, normal_solver="sharded", stop_tol=1e-6)
SHARDED_JAX_ITERS = 20
BATCH_CFG = dict(verbose=False, check_every=25, switch_admm=10**9)
BATCH_ITERS = 200


def _svec_of(blk, seed):
    return np.random.default_rng(seed).standard_normal(BlockStructure(blk).vec_len)


def _full_problem():
    return dict(blk=[("s", 4)] * 24, con_num=16, seed=5)  # tests/test_parallel.py:41


def _scale_problem():
    return dict(blk=[("s", 4)] * 512, con_num=64, seed=7)  # tests/test_parallel.py:83


def _sharded_problem():
    return dict(blk=[("s", 8)] * 12, con_num=600, seed=0)  # tests/test_parallel.py:192


def _small_sharded_problem():
    """The dry run's problem at 2 ranks (__graft_entry__.py:128): 2 block
    columns, so a solve to convergence takes few collectives."""
    return dict(blk=[("s", 6)] * 4, con_num=40, seed=1)


def _jax():
    """The JAX package's modules these tests compare with (imported here,
    not at the top: the card-only test runs without jax)."""
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp

    import cuadmm_tpu
    from cuadmm_tpu.models.random_sdp import random_certified_sdp
    from cuadmm_tpu.ops.projection import psd_project
    from cuadmm_tpu.ops.svec import device_maps
    from cuadmm_tpu.parallel import tri_shard
    from cuadmm_tpu.parallel.mesh import make_mesh

    return types.SimpleNamespace(jax=jax, jnp=jnp, pkg=cuadmm_tpu, certified=random_certified_sdp,
                                 psd_project=psd_project, device_maps=device_maps, tsd=tri_shard, make_mesh=make_mesh)


def _tri_factor(J):
    """tests/test_parallel.py:110-132's factor: n 512, B 64, f64, packed by
    the JAX package; its (nb, nb, B, B) grid, r and the dense answer."""
    from cuadmm_tpu.ops.tri_stream import make_layout, packed_cholesky, scatter_packed_aat

    n, B = 512, 64
    lay = make_layout(n, B)
    A = sp.random(n, 2 * n, density=0.05, random_state=1, format="csr")
    aat = (A @ A.T).tocoo()
    dm = float((A @ A.T).diagonal().mean())
    tiles = scatter_packed_aat(aat.row.astype(np.int64), aat.col.astype(np.int64), aat.data, lay, 1e-6, dm,
                               J.jnp.float64)
    grid = J.tsd.square_tiles_from_packed(np.asarray(packed_cholesky(tiles, lay)), lay)
    r = np.random.default_rng(0).standard_normal(n)
    dense = np.linalg.solve(np.asarray((A @ A.T).todense()) + 1e-6 * max(dm, 1.0) * np.eye(n), r)
    return grid, r, dense


def _chol_inputs():
    """tests/test_parallel.py:167-178's AA^T: n 500, B 32, eps 1e-8."""
    n = 500
    A = sp.random(n, 2 * n, density=0.05, random_state=1, format="csr")
    aat = (A @ A.T).tocsr()
    return aat, n, 32, 1e-8, float(aat.diagonal().mean())


def _family(n_instances, seed=0):
    """tests/test_torch_batch.py's family: instances sharing (blk, A), each
    with its own certified (b, C); port Problems."""
    blk = [("s", 5), ("s", 3)]
    base, *_ = t_certified(blk, con_num=10, seed=seed)
    rng = np.random.default_rng(seed)
    A = np.zeros((base.con_num, base.vec_len))
    A[base.At_cols, base.At_rows] = base.At_vals
    probs = []
    for i in range(n_instances):
        parts_x, parts_s = [], []
        for _, n in blk:
            q, _ = np.linalg.qr(rng.standard_normal((n, n)))
            k = max(1, n // 2)
            parts_x.append(_svec((q[:, :k] * rng.uniform(0.5, 2, k)) @ q[:, :k].T))
            parts_s.append(_svec((q[:, k:] * rng.uniform(0.5, 2, n - k)) @ q[:, k:].T))
        x_star, s_star = np.concatenate(parts_x), np.concatenate(parts_s)
        C = s_star + A.T @ rng.standard_normal(base.con_num)
        probs.append(cuadmm_tpu_torch.Problem.from_dense(blk, A, A @ x_star, C, name=f"inst{i}"))
    return probs


@pytest.fixture(scope="module")
def refs():
    """The JAX package's side, computed once: one-device projections, the
    factor grids and the mesh runs at every world size."""
    J = _jax()
    jax, jnp, jtsd, j_certified, j_make_mesh = J.jax, J.jnp, J.tsd, J.certified, J.make_mesh
    cuadmm_tpu = J.pkg
    t0 = time.perf_counter()
    out = {}
    for name, blk, seed, method, pack_to in (
        ("eigh", PROJ_BLK, 0, "eigh", 0), ("jacobi", PROJ_BLK, 0, "jacobi", 0),
        ("packed", PACKED_BLK, 1, "eigh", 8), ("poly64", [("s", 64)], 3, "poly", 0),
    ):
        st = BlockStructure(blk, "pow2", 64, pack_to)
        x = _svec_of(blk, seed)
        maps = J.device_maps(st, jnp.float64)
        out[f"proj_{name}"] = (x, np.asarray(jax.jit(lambda v: J.psd_project(v, maps, method=method))(jnp.asarray(x))))
    out["tri"] = _tri_factor(J)
    aat, n, B, eps, dm = _chol_inputs()
    scale = j_certified(**_scale_problem())[0]
    out["scale_1"] = cuadmm_tpu.SDPSolver(scale, cuadmm_tpu.SolverConfig(**SCALE_CFG)).solve(
        max_iter=100, stop_tol=0.0).pobj
    full = j_certified(**_full_problem())[0]
    sharded = j_certified(**_sharded_problem())[0]
    for D in WORLDS:
        mesh = j_make_mesh(D)
        out[f"full_{D}"] = cuadmm_tpu.SDPSolver(full, cuadmm_tpu.SolverConfig(**FULL_CFG), mesh=mesh).solve(
            max_iter=3000, stop_tol=1e-6)
        grid, r, _ = out["tri"]
        out[f"tri_{D}"] = np.asarray(jtsd.sharded_tri_solve(jtsd.shard_factor(grid, mesh), jnp.asarray(r), mesh))
        nb, n_pad = jtsd.make_grid_layout(n, D, B)
        g = jtsd.sharded_cholesky(jtsd.sharded_scatter_aat(aat, n, nb, B, mesh, eps=eps, diag_mean=dm,
                                                           dtype=np.float64), mesh)
        rc = np.zeros(n_pad)
        rc[:n] = np.random.default_rng(0).standard_normal(n)
        out[f"chol_{D}"] = (np.asarray(g), rc)
        s = cuadmm_tpu.SDPSolver(sharded, cuadmm_tpu.SolverConfig(**SHARDED_CFG), mesh=mesh)
        assert s.params.neq.mode == "sharded"
        out[f"sharded_{D}"] = (np.asarray(s.params.neq.shard_grid), int(s.params.neq.applies),
                               s.solve(max_iter=SHARDED_JAX_ITERS, stop_tol=0.0))
    s = cuadmm_tpu.SDPSolver(j_certified(**_small_sharded_problem())[0], cuadmm_tpu.SolverConfig(**SHARDED_CFG),
                             mesh=j_make_mesh(2))
    out["sharded_conv"] = (np.asarray(s.params.neq.shard_grid), int(s.params.neq.applies), s.solve(max_iter=20000))
    print(f"JAX references: {time.perf_counter() - t0:.1f} s")
    return out


def _checks(D, refs):
    """Every check of one world size, for ``rank_jobs.run_checks``."""
    checks = [
        (f"proj_{name}", rank_jobs.project, dict(blk=blk, svec=refs[f"proj_{name}"][0], method=m, pack_to=p))
        for name, blk, m, p in (("eigh", PROJ_BLK, "eigh", 0), ("jacobi", PROJ_BLK, "jacobi", 0),
                                ("packed", PACKED_BLK, "eigh", 8), ("poly64", [("s", 64)], "poly", 0))
    ]
    grid, r, _ = refs["tri"]
    aat, n, B, eps, dm = _chol_inputs()
    sgrid, sapplies, _ = refs[f"sharded_{D}"]
    sharded = t_certified(**_sharded_problem())[0]
    checks += [
        ("full", rank_jobs.solve,
         dict(prob=t_certified(**_full_problem())[0], config=FULL_CFG, runs=[(3000, 1e-6)])),
        ("scale", rank_jobs.solve,
         dict(prob=t_certified(**_scale_problem())[0], config=SCALE_CFG, runs=[(100, 0.0)])),
        ("tri", rank_jobs.tri_solve, dict(square_tiles=grid, r=r)),
        ("chol", rank_jobs.cholesky, dict(aat=aat, n=n, block=B, eps=eps, diag_mean=dm, r=refs[f"chol_{D}"][1])),
        ("sharded_jax", rank_jobs.solve, dict(prob=sharded, config=SHARDED_CFG, runs=[(SHARDED_JAX_ITERS, 0.0)],
                                      grid=sgrid, applies=sapplies)),
        ("sharded_own", rank_jobs.solve, dict(prob=sharded, config=SHARDED_CFG, runs=[(SHARDED_JAX_ITERS, 0.0)])),
        ("auto", rank_jobs.solve, dict(prob=t_certified(**_full_problem())[0],
                               config=dict(FULL_CFG, normal_solver="auto"), runs=[(1, 0.0)])),
        ("batch", rank_jobs.batch, dict(problems=_family(4), config=dict(BATCH_CFG, projection="eigh"),
                                        max_iter=BATCH_ITERS, stop_tol=0.0)),
    ]
    if D == 2:  # the runs to convergence: a collective costs about 1 ms at 2 CPU ranks, 4 at 4
        cgrid, capplies, _ = refs["sharded_conv"]
        prob, *_ = t_certified([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
        checks += [
            ("sharded_conv", rank_jobs.solve,
             dict(prob=t_certified(**_small_sharded_problem())[0], config=SHARDED_CFG,
                  runs=[(20000, 1e-6)], grid=cgrid, applies=capplies)),
            ("dryrun", dryrun_job, {}),
            ("escalated", rank_jobs.escalated,
             dict(prob=prob, config=dict(verbose=False, check_every=25, projection="eigh"),
                  max_iter=4000, stop_tol=1e-6)),
        ]
    return checks


@pytest.fixture(scope="module")
def ranks(refs):
    """{world: [rank 0's results, rank 1's, ...]} from one spawn per world,
    the worlds at once."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {D: pool.submit(run_ranks, rank_jobs.run_checks, D, "gloo", "cpu", args=(_checks(D, refs),),
                                  timeout_s=TIMEOUT_S) for D in WORLDS}
        out = {D: f.result() for D, f in futures.items()}
    print(f"worlds {WORLDS}: {time.perf_counter() - t0:.1f} s")
    return out


RANK_OWN = ("shares", "slab", "seconds", "total_time")  # a rank's own share and clocks, not compared


def _same_on_every_rank(results, key):
    """The ranks' results of one check are bitwise equal; rank 0's."""
    first = results[0][key]

    def eq(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a if k not in RANK_OWN)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        return a == b or (a != a and b != b)

    for r, res in enumerate(results[1:], 1):
        assert eq(res[key], first), f"rank {r} differs from rank 0 in {key}"
    return first


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("case", ["eigh", "jacobi", "packed"])
def test_sharded_projection_matches_single_device(ranks, refs, D, case):
    """tests/test_parallel.py:26: the projection with its buckets split over
    the ranks equals the JAX package's on one device, rtol and atol 1e-12
    (jacobi 1e-10: two Jacobi implementations), packed buckets included."""
    got = _same_on_every_rank(ranks[D], f"proj_{case}")
    tol = 1e-10 if case == "jacobi" else 1e-12
    np.testing.assert_allclose(got["svec"], refs[f"proj_{case}"][1], rtol=tol, atol=tol)
    split = [s for s in got["shares"] if s[2] == 0]
    assert split, "no bucket was split over the ranks"
    assert got["all_reduces"] == len(split)  # one masked all_reduce a split bucket


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("case", ["eigh", "jacobi", "packed", "poly64"])
def test_sharded_psd_project_matches_jax(ranks, refs, D, case):
    """psd_project (svec coordinates) over the ranks equals the JAX
    psd_project on one device, to the tolerances of the pool route's tests
    (1e-12; jacobi 1e-10; the row-split poly filter 1e-9), with the pool
    route's collectives: one a split bucket, 40 for the 64 block's rows."""
    got = _same_on_every_rank(ranks[D], f"proj_{case}")
    tol = {"jacobi": 1e-10, "poly64": 1e-9}.get(case, 1e-12)
    np.testing.assert_allclose(got["svec_direct"], refs[f"proj_{case}"][1], rtol=tol, atol=tol)
    assert got["direct_all_reduces"] == got["all_reduces"] > 0


@pytest.mark.parametrize("D", WORLDS)
def test_shard_blocks_layout(ranks, D):
    """tests/test_parallel.py:40: a 16-block bucket over D ranks takes
    16 / D blocks a rank, contiguous, as XLA's batch sharding places them
    (jax's devices_indices_map for make_mesh(D)); uneven counts as XLA's
    uneven sharding: ceil(count / D) a rank, the last ranks the rest."""
    J = _jax()
    from jax.sharding import NamedSharding, PartitionSpec as P

    jmesh = J.make_mesh(D)
    for count in (16, 49, 11):
        if count % D:
            want = [(min(r * -(-count // D), count), min((r + 1) * -(-count // D), count)) for r in range(D)]
        else:
            imap = NamedSharding(jmesh, P("blocks", None, None)).devices_indices_map((count, 4, 4))
            want = [(imap[d][0].start or 0, imap[d][0].stop or count) for d in jmesh.devices]
        got = [shard_bounds(count, Mesh(size=D, rank=r, device=CPU)) for r in range(D)]
        assert got == want, (count, got, want)
    shares = ranks[D][1]["proj_eigh"]["shares"]
    assert [s[3] for s in shares if s[0] == 16] == [shard_bounds(16, Mesh(size=D, rank=1, device=CPU))]


@pytest.mark.parametrize("D", WORLDS)
def test_full_solve_sharded_matches_unsharded(ranks, refs, D):
    """tests/test_parallel.py:39: a solve over D ranks stops on the JAX
    mesh run's iteration with pobj within 1e-8 (relative)."""
    got = _same_on_every_rank(ranks[D], "full")["runs"][0]
    want = refs[f"full_{D}"]
    assert got["converged"] and want.converged
    assert got["iterations"] == want.iterations
    assert abs(got["pobj"] - want.pobj) < 1e-8 * (1 + abs(want.pobj))


@pytest.mark.parametrize("D", WORLDS)
def test_single_huge_block_inner_sharding_matches(ranks, refs, D):
    """tests/test_parallel.py:64: one 64 block under "poly" is split by rows
    (too few blocks for the batch axis) and equals the JAX filter on one
    device to 1e-9; 40 all_reduces a projection (13 steps of 3 products,
    and the last product)."""
    got = _same_on_every_rank(ranks[D], "proj_poly64")
    np.testing.assert_allclose(got["svec"], refs["proj_poly64"][1], rtol=1e-9, atol=1e-9)
    assert got["shares"][0][2] == 1 and got["all_reduces"] == 40


@pytest.mark.parametrize("D", WORLDS)
def test_mesh_scaling_smoke(ranks, refs, D):
    """tests/test_parallel.py:77: 100 iterations of 512 blocks over 1, 2
    and 4 ranks give one pobj (1e-8 relative), the JAX package's on one
    device; the rates (shared CPU cores) are printed, not asserted."""
    p1 = cuadmm_tpu_torch.SDPSolver(t_certified(**_scale_problem())[0], cuadmm_tpu_torch.SolverConfig(**SCALE_CFG),
                                    device="cpu").solve(max_iter=100, stop_tol=0.0).pobj
    got = _same_on_every_rank(ranks[D], "scale")["runs"][0]
    for p in (p1, got["pobj"]):
        assert abs(p - refs["scale_1"]) < 1e-8 * (1 + abs(refs["scale_1"]))
    print(f"{D} ranks: {100 / got['seconds']:.1f} it/s, {got['all_reduces'] / 100:.0f} all_reduces an iteration")


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_tri_solve_matches_dense(ranks, refs, D):
    """tests/test_parallel.py:105: the sharded triangular solve of a packed
    f64 factor (n 512, B 64) against a dense solve and against the JAX
    package's sharded solve on make_mesh(D), each to 1e-10 (relative)."""
    y = _same_on_every_rank(ranks[D], "tri")
    dense = refs["tri"][2]
    assert np.linalg.norm(y - dense) / np.linalg.norm(dense) < 1e-10
    jy = refs[f"tri_{D}"]
    assert np.linalg.norm(y - jy) / np.linalg.norm(jy) < 1e-10


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_cholesky_matches_jax_and_dense(ranks, refs, D):
    """tests/test_parallel.py:163: the distributed Cholesky (live tiles
    only) gives the JAX package's factor grid on make_mesh(D) tile for
    tile (1e-12 of the largest entry; both f64, the same products summed
    in another order), and its solve the dense one to 1e-10."""
    res = ranks[D]
    _same_on_every_rank(res, "chol")
    grid = np.concatenate([r["chol"]["slab"] for r in res], axis=1)
    want, rc = refs[f"chol_{D}"]
    assert grid.shape == want.shape and all(r["chol"]["finite"] for r in res)
    np.testing.assert_allclose(grid, want, rtol=0, atol=1e-12 * np.abs(want).max())
    aat, n, _, eps, dm = _chol_inputs()
    ref = np.linalg.solve(aat.toarray() + eps * max(dm, 1.0) * np.eye(n), rc[:n])
    y = res[0]["chol"]["y"][:n]
    assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-10


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_normal_solver_in_full_solve(ranks, refs, D):
    """tests/test_parallel.py:186's problem with ``sharded`` over D ranks.
    Carrying the JAX package's f64 grid from make_mesh(D) with its sweep
    count, the port's info rows equal the JAX sharded run's over 20
    iterations to rtol 1e-8. With its own f32 factor (the port's build:
    B 64, nb a multiple of D) the run's errRp stays within 1e-6 (relative)
    of the carried one's: both solves reach their refinement target."""
    carried = _same_on_every_rank(ranks[D], "sharded_jax")
    want = refs[f"sharded_{D}"][2]
    run = carried["runs"][0]
    assert carried["mode"] == "sharded" and run["iterations"] == want.iterations == SHARDED_JAX_ITERS
    for f in ("pobj", "dobj", "errRp", "errRd", "relgap", "sig"):
        np.testing.assert_allclose(run["info"][f], want.info[f], rtol=1e-8, atol=0, err_msg=f)
    own = _same_on_every_rank(ranks[D], "sharded_own")
    nb = refs[f"sharded_{D}"][0].shape[0]
    assert own["mode"] == "sharded" and own["grid_shape"] == (nb, nb // D, 64, 64)
    np.testing.assert_allclose(own["runs"][0]["info"]["errRp"], run["info"]["errRp"], rtol=1e-6, atol=0)


def test_sharded_solve_reaches_certified_optimum(ranks, refs):
    """``sharded`` to stop_tol 1e-6 over 2 ranks (the dry run's problem,
    2 block columns) from the JAX package's grid: the JAX run's iteration
    count, its info rows to rtol 1e-8, and the certified optimum to 1e-3
    (tests/test_parallel.py:206's bound)."""
    *_, opt = t_certified(**_small_sharded_problem())
    got = _same_on_every_rank(ranks[2], "sharded_conv")["runs"][0]
    want = refs["sharded_conv"][2]
    assert got["converged"] and want.converged and got["iterations"] == want.iterations
    assert abs(got["pobj"] - opt) / (1 + abs(opt)) < 1e-3
    for f in ("pobj", "dobj", "errRp", "errRd", "relgap"):  # atol: the residuals' rounding floor near 1e-10
        np.testing.assert_allclose(got["info"][f], want.info[f], rtol=1e-8, atol=1e-12, err_msg=f)


def test_dryrun_multichip(ranks):
    """__graft_entry__.py::dryrun_multichip's counterpart over 2 ranks: a
    step, the sharded triangular solve (3 nb all_reduces) and a sharded f32
    solve to 1e-5 within 1e-2 of its optimum (the job raises otherwise)."""
    got = _same_on_every_rank(ranks[2], "dryrun")
    assert got["tri_solve_all_reduces"] == 3 * 2 and np.all(np.isfinite(got["tri_solve"]))
    assert abs(got["pobj"] - got["optimum"]) / (1 + abs(got["optimum"])) < 1e-2


@pytest.mark.parametrize(
    "con_num,bw",
    [(68350, 4), (68350, 68349), (200000, 60000), (80000, 79999), (73001, 20000), (154256, 20512)],
)
def test_past_ceiling_mode_two_devices(con_num, bw):
    """``past_ceiling_mode(..., n_devices=2)``, given the JAX package's
    numbers, is the JAX rule (cuadmm_tpu/ops/chol.py:809-840) at a mesh of
    2: sharded where no single-device factor fits, and only on an
    accelerator."""
    _jax()
    from cuadmm_tpu.ops import chol as jchol
    from cuadmm_tpu.ops import tri_stream as jts

    from cuadmm_tpu_torch.ops.limits import CardLimits

    jax_limits = CardLimits(  # cuadmm_tpu/ops/chol.py:99-109, tri_stream.py:463-478
        total_bytes=16 * 10**9, packed_max_con=jchol.PACKED_MAX_CON, band_max_bytes=jchol.BAND_MAX_BYTES,
        dense_a_budget=6 * 1024**3, precond_max_n_pad=32768,
        band_model=lambda T, B, nb: T * B * B * 4 / 800e9 + T * 3e-6,
    )
    blay = jts.make_band_layout(con_num, bw)  # cuadmm_tpu/ops/chol.py:813-840, n_mesh 2
    band_bytes = blay.T * blay.block * blay.block * 4
    packed_bytes = jts.make_layout(con_num).T * 1024 * 1024 * 4 if con_num <= jchol.PACKED_MAX_CON else None
    if packed_bytes is not None and packed_bytes <= band_bytes * 1.15:
        want = "packed"
    elif band_bytes <= jchol.BAND_MAX_BYTES:
        want = "banded"
    else:
        want = "packed" if packed_bytes is not None else "sharded"
    assert tchol.past_ceiling_mode(con_num, bw, True, 2, jax_limits) == want
    assert tchol.past_ceiling_mode(con_num, bw, False, 2, jax_limits) == "cg"
    if (con_num, bw) == (200000, 60000):
        assert tchol.past_ceiling_mode(con_num, bw, True, 2, jax_limits) == "sharded"


@pytest.mark.parametrize("D", WORLDS)
def test_auto_with_mesh_resolves_as_jax(ranks, D):
    """``auto`` over a mesh picks what the JAX package's does with
    make_mesh(D) on the same device kind."""
    J = _jax()
    got = _same_on_every_rank(ranks[D], "auto")
    cfg = dict(FULL_CFG, normal_solver="auto")
    s = J.pkg.SDPSolver(J.certified(**_full_problem())[0], J.pkg.SolverConfig(**cfg), mesh=J.make_mesh(D))
    assert got["mode"] == s.params.neq.mode


@pytest.mark.parametrize("D", WORLDS)
def test_ranks_iterates_bitwise_equal(ranks, D):
    """Every rank ends every solve with the same X, y, S and info rows, bit
    for bit (the state is whole on every rank, the gathers exact)."""
    for key in ("full", "scale", "sharded_own", "sharded_jax", "batch") + (("sharded_conv", "escalated") if D == 2 else ()):
        _same_on_every_rank(ranks[D], key)


@pytest.mark.parametrize("D", WORLDS)
def test_batched_over_mesh_matches_single_solves(ranks, D):
    """BatchedSDPSolver(mesh=) over D ranks (4 instances: 4 / D a rank):
    every rank returns every instance, each within 1e-9 (relative) of its
    own single solve (projection "eigh") in its info rows and X."""
    got = _same_on_every_rank(ranks[D], "batch")
    assert len(got) == 4
    for prob, rb in zip(_family(4), got):
        rs = cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(projection="eigh", **BATCH_CFG),
                                        device="cpu").solve(max_iter=BATCH_ITERS, stop_tol=0.0)
        assert rb["iterations"] == rs.iterations == BATCH_ITERS
        for f in ("pobj", "errRp", "errRd"):
            np.testing.assert_allclose(rb["info"][f], rs.info[f], rtol=1e-9, atol=0, err_msg=f)
        np.testing.assert_allclose(rb["X"], rs.X, rtol=0, atol=1e-9 * (1 + np.abs(rs.X).max()))


def test_solve_escalated_over_mesh(ranks):
    """solve_escalated(mesh=) over 2 ranks: both phases on the mesh, the
    same iterations and pobj (1e-9) as on one device."""
    prob, *_ = t_certified([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)
    one = cuadmm_tpu_torch.solve_escalated(
        prob, cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=25, projection="eigh"), 4000, 1e-6,
        device="cpu")
    got = _same_on_every_rank(ranks[2], "escalated")
    assert got["converged"] and got["iterations"] == one.iterations
    assert abs(got["pobj"] - one.pobj) < 1e-9 * (1 + abs(one.pobj))


def test_rank_failure_raises_within_timeout():
    """A rank that raises while the other waits in a collective: run_ranks
    kills both and raises with the failing rank's traceback, long before
    its timeout; ranks that outlive the timeout raise TimeoutError."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(rank_jobs.fail, 2, device="cpu", args=(1,), timeout_s=120.0)
    assert time.perf_counter() - t0 < 60.0
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        run_ranks(rank_jobs.sleep, 2, device="cpu", args=(600.0,), timeout_s=10.0)
    assert time.perf_counter() - t0 < 30.0


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_project_grid_buckets_bitwise():
    """On the card: two gloo ranks on cuda:0 project the 20x60 grid's
    buckets through K4 (every bucket split, so K4 runs on each rank's
    share of each) and match one rank's projection bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 has no CPU or interpret mode")
    from cuadmm_tpu_torch.models.chordal import maxcut_chordal
    from cuadmm_tpu_torch.ops.svec import device_maps, pool_from_svec, svec_from_pool
    from cuadmm_tpu_torch.ops.projection import psd_project_pool

    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(20), path(60)) + sp.kron(path(20), sp.eye(60))
    prob = maxcut_chordal((W + W.T).tocsr())[0]
    x = np.random.default_rng(0).standard_normal(prob.vec_len)
    got = run_ranks(rank_jobs.grid_buckets_k4, 2, "gloo", "cuda:0", args=(prob, x), timeout_s=600.0)
    st = BlockStructure(prob.blk, "pow2", 64, 0)
    maps = device_maps(st, torch.float64, torch.device("cuda"))
    one = svec_from_pool(psd_project_pool(pool_from_svec(torch.as_tensor(x, device="cuda"), maps), maps,
                                          method="jacobi"), maps).cpu().numpy()
    for r in got:
        assert r["k4"] == len(st.buckets)
        assert r["svec"].tobytes() == got[0]["svec"].tobytes()
    np.testing.assert_array_equal(got[0]["svec"], one)
