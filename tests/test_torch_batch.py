"""The port's BatchedSDPSolver against cuadmm_tpu's and its own single solves.

The family is tests/test_batch.py's ``_family``: instances sharing (blk,
A) with different certified (b, C). JAX is imported inside the tests that
compare with it, so the card-only check at the end runs with
``--noconftest`` on a machine without jax.
"""

import numpy as np
import pytest
import torch

import cuadmm_tpu_torch
from cuadmm_tpu_torch import BatchedSDPSolver
from cuadmm_tpu_torch.models.random_sdp import _svec, random_certified_sdp
from cuadmm_tpu_torch.trace import COUNTS

torch.set_num_threads(1)

FIELDS = ("pobj", "dobj", "errRp", "errRd", "relgap", "sig")
CFG = dict(verbose=False, check_every=25, switch_admm=10**9)


def _family_data(n_instances, seed=0):
    """tests/test_batch.py::_family's instances as (blk, A, b, C, optimum)."""
    blk = [("s", 5), ("s", 3)]
    base, *_ = random_certified_sdp(blk, con_num=10, seed=seed)
    rng = np.random.default_rng(seed)
    A = np.zeros((base.con_num, base.vec_len))
    A[base.At_cols, base.At_rows] = base.At_vals
    out = []
    for _ in range(n_instances):
        parts_x, parts_s = [], []
        for t, n in blk:
            q, _ = np.linalg.qr(rng.standard_normal((n, n)))
            k = max(1, n // 2)
            X = (q[:, :k] * rng.uniform(0.5, 2, k)) @ q[:, :k].T
            S = (q[:, k:] * rng.uniform(0.5, 2, n - k)) @ q[:, k:].T
            parts_x.append(_svec(X))
            parts_s.append(_svec(S))
        x_star, s_star = np.concatenate(parts_x), np.concatenate(parts_s)
        y_star = rng.standard_normal(base.con_num)
        C = s_star + A.T @ y_star
        out.append((blk, A, A @ x_star, C, float(C @ x_star)))
    return out


def _port_family(n_instances, seed=0):
    data = _family_data(n_instances, seed)
    probs = [cuadmm_tpu_torch.Problem.from_dense(blk, A, b, C, name=f"inst{i}")
             for i, (blk, A, b, C, _) in enumerate(data)]
    return probs, [d[-1] for d in data]


def test_batched_matches_jax_and_single_solves():
    """tests/test_batch.py::test_batched_matches_individual on both
    packages: each instance converges to its optimum, the port's pobj
    within 1e-6 (relative) and X within 5e-5 of the JAX batch's and of the
    port's single eigh solve of that instance."""
    pytest.importorskip("jax")
    import cuadmm_tpu
    from cuadmm_tpu.parallel.batch import BatchedSDPSolver as JBatched

    data = _family_data(3)
    probs_j = [cuadmm_tpu.Problem.from_dense(blk, A, b, C) for blk, A, b, C, _ in data]
    probs_t, objs = _port_family(3)
    res_j = JBatched(probs_j, cuadmm_tpu.SolverConfig(**CFG)).solve(max_iter=6000, stop_tol=1e-6)
    res_t = BatchedSDPSolver(probs_t, cuadmm_tpu_torch.SolverConfig(projection="eigh", **CFG), device="cpu").solve(
        max_iter=6000, stop_tol=1e-6)
    cfg1 = cuadmm_tpu_torch.SolverConfig(projection="eigh", normal_solver="auto", **CFG)
    for i, (rj, rt, obj) in enumerate(zip(res_j, res_t, objs)):
        assert rt.converged and abs(rt.pobj - obj) / (1 + abs(obj)) < 1e-4
        assert abs(rt.pobj - rj.pobj) < 1e-6 * (1 + abs(rj.pobj))
        np.testing.assert_allclose(rt.X, rj.X, rtol=0, atol=5e-5)
        single = cuadmm_tpu_torch.SDPSolver(probs_t[i], cfg1, device="cpu").solve(max_iter=6000, stop_tol=1e-6)
        assert rt.iterations == single.iterations
        assert abs(rt.pobj - single.pobj) < 1e-6 * (1 + abs(single.pobj))
        np.testing.assert_allclose(rt.X, single.X, rtol=0, atol=5e-5)
        assert len(rt.info["errRp"]) == rt.iterations


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_of_one_equals_single_solve(dtype):
    """One instance through the batch is SDPSolver, both with projection "eigh"
    (1e-12 in f64; in f32 to the state's rounding, the single solve's
    probe and stall detector never engaging in 200 iterations at
    stop_tol 0)."""
    probs, _ = _port_family(1)
    cfg = cuadmm_tpu_torch.SolverConfig(dtype=dtype, projection="eigh", **CFG)
    rb = BatchedSDPSolver(probs, cfg, device="cpu").solve(max_iter=200, stop_tol=0.0)[0]
    rs = cuadmm_tpu_torch.SDPSolver(probs[0], cfg, device="cpu").solve(max_iter=200, stop_tol=0.0)
    tol = 1e-12 if dtype == "float64" else 1e-6
    assert rb.iterations == rs.iterations == 200
    for f in FIELDS:
        np.testing.assert_allclose(rb.info[f], rs.info[f], rtol=tol, atol=0, err_msg=f)
    np.testing.assert_allclose(rb.X, rs.X, rtol=0, atol=tol * (1 + np.abs(rs.X).max()))


def test_f32_batch_converges():
    probs, objs = _port_family(3, seed=2)
    cfg = cuadmm_tpu_torch.SolverConfig(dtype="float32", **CFG)
    for res, obj in zip(BatchedSDPSolver(probs, cfg, device="cpu").solve(max_iter=6000, stop_tol=2e-4), objs):
        assert res.converged and abs(res.pobj - obj) / (1 + abs(obj)) < 5e-3


def test_batch_rejects_mismatched_pattern_and_mesh():
    p1, *_ = random_certified_sdp([("s", 4)], con_num=5, seed=1)
    p2, *_ = random_certified_sdp([("s", 5)], con_num=5, seed=1)
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False)
    with pytest.raises(ValueError):
        BatchedSDPSolver([p1, p2], cfg, device="cpu")
    # mesh= takes a rank mesh (parallel/mesh.py::make_mesh); tests/
    # test_torch_parallel.py runs the batch over 2 and 4 ranks.
    with pytest.raises(TypeError, match="Mesh"):
        BatchedSDPSolver([p1, p1], cfg, mesh=object(), device="cpu")


@pytest.mark.parametrize("mode", ["precond", "dense", "auto", "cg", "host", "split", "packed", "banded"])
def test_batched_normal_solve_is_per_instance(mode):
    """(B, con_num) right-hand sides through each mode that serves a batch
    on the CPU (sharded needs a mesh: tests/test_torch_parallel.py): the
    same answers as one instance at a time."""
    probs, _ = _port_family(3)
    rng = np.random.default_rng(4)
    s = cuadmm_tpu_torch.SDPSolver(probs[0], cuadmm_tpu_torch.SolverConfig(
        verbose=False, normal_solver=mode), device="cpu")
    assert s.params.neq.mode == ("split" if mode == "auto" else mode)
    rhs = torch.as_tensor(rng.standard_normal((3, probs[0].con_num)))
    warm = torch.as_tensor(rng.standard_normal((3, probs[0].con_num)))
    batched = s.params.neq.solve(rhs, warm=warm)
    for b in range(3):
        one = s.params.neq.solve(rhs[b], warm=warm[b])
        np.testing.assert_allclose(batched[b].numpy(), one.numpy(), rtol=1e-12, atol=1e-12, err_msg=mode)


@pytest.mark.cuda
def test_batched_precond_launches_k1_per_instance_on_card():
    """On the card a batch of B instances in precond launches K1 once a
    refinement sweep for all B (K1 over B), and each instance's iterate
    matches its own single solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU or interpret mode")
    probs, _ = _port_family(4)
    cfg = cuadmm_tpu_torch.SolverConfig(normal_solver="precond", projection="eigh", check_every=10, **{
        k: v for k, v in CFG.items() if k != "check_every"})
    batch = BatchedSDPSolver(probs, cfg)
    applies = batch.params.neq.applies
    batch.solve(max_iter=2, stop_tol=0.0)  # builds the kernel
    torch.cuda.synchronize()
    before, served = COUNTS["k1"], COUNTS["k1_rhs"]
    res = batch.solve(max_iter=20, stop_tol=0.0)
    torch.cuda.synchronize()
    assert COUNTS["k1"] - before == 20 * 2 * applies  # sGS: two solves an iteration
    assert COUNTS["k1_rhs"] - served == 4 * (COUNTS["k1"] - before)
    for i, rb in enumerate(res):
        rs = cuadmm_tpu_torch.SDPSolver(probs[i], cfg).solve(max_iter=20, stop_tol=0.0)
        np.testing.assert_allclose(rb.info["errRp"], rs.info["errRp"], rtol=1e-9, atol=0)


@pytest.mark.parametrize("method,pack_to", [("eigh", 0), ("jacobi", 0), ("poly", 0), ("eigh", 8), ("jacobi", 8)],
                         ids=["eigh", "jacobi", "poly", "eigh_packed", "jacobi_packed"])
def test_batched_projection_matches_jax_vmap(method, pack_to):
    """psd_project_pool on (B, pool_len): each instance's own projection, as
    jax.vmap of the JAX function gives it, packed buckets included."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from cuadmm_tpu.ops import projection as jproj
    from cuadmm_tpu.ops import svec as jsvec

    from cuadmm_tpu_torch.ops import projection as tproj
    from cuadmm_tpu_torch.ops import svec as tsvec
    from cuadmm_tpu_torch.structure import BlockStructure

    blk = [("s", 1), ("s", 3), ("u", 4), ("s", 5), ("s", 2), ("s", 7), ("s", 3)]
    st = BlockStructure(blk, "pow2", 64, pack_to)
    assert any(bk.packed for bk in st.buckets) == bool(pack_to)
    jm = jsvec.device_maps(st, jnp.float64)
    tm = tsvec.device_maps(st, torch.float64, torch.device("cpu"))
    rng = np.random.default_rng(6)
    pools = np.stack([
        np.asarray(jsvec.pool_from_svec(jnp.asarray(rng.standard_normal(st.vec_len) * 10.0**-k), jm))
        for k in range(3)
    ])
    pj = np.asarray(jax.vmap(lambda p: jproj.psd_project_pool(p, jm, method=method))(jnp.asarray(pools)))
    pt = tproj.psd_project_pool(torch.as_tensor(pools), tm, method=method).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-10)
    for b in range(3):  # and one instance alone
        one = tproj.psd_project_pool(torch.as_tensor(pools[b]), tm, method=method).numpy()
        np.testing.assert_allclose(pt[b], one, rtol=0, atol=1e-12)
