"""The chunk runner (solver/step.py::make_chunk_runner) against run_chunk.

On the CPU the runner keeps its whole structure (static state updated in
place, one recording per branch, the chunk's row buffer, the runner cache
and the eigh segment list) and its replay calls the recorded step on the
static buffers: the plain version beside the CUDA graphs. It must give
run_chunk's state and info rows bit for bit, in every normal solver that
the runner records, across the sGS/ADMM switch, through a recovery that
swaps the step, over a batch, and with eigh buckets between segments. One
chunk of it matches the JAX package's make_chunk_runner to atol 1e-9
(tests/test_torch_step.py's tolerance). The ``cuda`` tests hold the CUDA
graphs to the eager loop bit for bit on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_chunk.py``.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cuadmm_tpu_torch
from cuadmm_tpu_torch import BatchedSDPSolver
from cuadmm_tpu_torch.models.chordal import maxcut_chordal
from cuadmm_tpu_torch.models.quasar import quasar_constraints
from cuadmm_tpu_torch.models.random_sdp import random_certified_sdp
from cuadmm_tpu_torch.ops import chol as tchol
from cuadmm_tpu_torch.ops import limits as tlim
from cuadmm_tpu_torch.ops.dispatch import bucket_method
from cuadmm_tpu_torch.trace import COUNTS
from cuadmm_tpu_torch.solver import driver
from cuadmm_tpu_torch.solver import step as step_mod
from cuadmm_tpu_torch.solver.state import SolverState

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(SolverState)]


def _certified():
    return random_certified_sdp([("s", 6), ("s", 4), ("s", 6)], con_num=12, seed=3)[0]


def _grid(rows=4, cols=6):
    """Max-cut on the 4-neighbour grid graph: mixed block sizes."""
    path = lambda k: sp.diags([np.ones(k - 1)], [1], shape=(k, k))
    W = sp.kron(sp.eye(rows), path(cols)) + sp.kron(path(rows), sp.eye(cols))
    return maxcut_chordal((W + W.T).tocsr())[0]


def _quasar(n_poses=6):
    """QUASAR's constraints with b = (N+1) e_0 and a seeded C: auto
    resolves to split with a coupled prefix (61 rows at N = 6)."""
    rows, cols, vals, con_num, n = quasar_constraints(n_poses)
    m = np.random.default_rng(0).standard_normal((n, n))
    r, c = np.tril_indices(n)
    return cuadmm_tpu_torch.Problem(
        blk=[("s", n)], con_num=con_num, At_rows=rows, At_cols=cols, At_vals=vals,
        b_indices=np.array([0]), b_vals=np.array([n_poses + 1.0]),
        C_indices=np.arange(len(r)), C_vals=((m + m.T) / 2)[r, c] * np.where(r == c, 1.0, np.sqrt(2.0)),
    )


def _solver(prob, device="cpu", **cfg):
    kw = dict(verbose=False, check_every=10, switch_admm=0, normal_solver="precond", projection="jacobi")
    kw.update(cfg)
    return cuadmm_tpu_torch.SDPSolver(prob, cuadmm_tpu_torch.SolverConfig(**kw), device=device)


def _step(solver, stop_tol=0.0, rp_hp=False, projection=None):
    """The solver's step; ``projection`` (a per-bucket dict, as "auto"
    resolves to) replaces the solver's."""
    cfg = solver.config
    return step_mod.make_step(
        stop_tol=stop_tol, switch_admm=cfg.switch_admm, sig_update_threshold=cfg.sig_update_threshold,
        sig_update_stage_1=cfg.sig_update_stage_1, sig_min=cfg.sig_min, sig_max=cfg.sig_max,
        projection=solver._projection if projection is None else projection,
        rp_hp=solver._rp_hp if rp_hp else None,
    )


def _start(solver):
    X, y, S = solver._initial_scaled
    return solver._initial_state(X, y, S, solver.config.sig)


def _assert_same(a, b, what=""):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f"{what} {f}"


def _runner_vs_eager(step, params, state, chunks, it_host=0):
    """The chunks through one runner and through run_chunk from ``state``,
    state and rows bitwise equal after each; returns the runner."""
    runner = step_mod.make_chunk_runner(step, params)
    s_r = s_e = state
    for c in chunks:
        s_r, rows_r = runner(s_r, it_host, c)
        s_e, rows_e = step_mod.run_chunk(step, s_e, params, it_host, c)
        assert rows_r.shape == rows_e.shape and torch.equal(rows_r, rows_e), f"rows after iteration {it_host + c}"
        _assert_same(s_r, s_e, f"state after iteration {it_host + c}")
        it_host += c
    return runner


# (problem, solver config, step options, chunks): every normal solver the
# runner records, each branch, the done guard, f32 with rp_hp, eigh
# segments alone and among other methods.
CASES = {
    "precond_admm": (_certified, {}, {}, [7, 5]),
    "sgs_switch_inside_a_chunk": (_certified, dict(switch_admm=5), {}, [10, 3]),
    "done_guard_mid_chunk": (_certified, dict(switch_admm=10**9), dict(stop_tol=2e-2), [60, 40]),
    "f32_rp_hp": (_certified, dict(dtype="float32"), dict(rp_hp=True), [6, 6]),
    "dense": (_certified, dict(normal_solver="dense"), {}, [6, 4]),
    "split": (_quasar, dict(normal_solver="auto"), {}, [5, 5]),
    "banded": (lambda: _grid(8, 12), dict(normal_solver="banded"), {}, [4, 3]),
    "packed": (lambda: _grid(8, 12), dict(normal_solver="packed"), {}, [4, 3]),
    "eigh_segments": (_grid, dict(projection="eigh"), {}, [5, 5]),
    "eigh_poly_eigh": (lambda: _grid(8, 12), {}, dict(projection={0: "eigh", 1: "poly", 2: "eigh"}), [5, 5]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_replay_matches_run_chunk(case):
    make, cfg, opts, chunks = CASES[case]
    solver = _solver(make(), **cfg)
    if case == "split":
        assert solver.params.neq.mode == "split" and solver.params.neq.factor.p == 61
    step = _step(solver, **opts)
    runner = _runner_vs_eager(step, solver.params, _start(solver), chunks)
    branches = {step.in_sgs(k) for k in range(sum(chunks))}
    assert set(runner.recordings) == branches
    assert not runner.graphs and all(rec.plain is not None for rec in runner.recordings.values())
    projection = opts.get("projection", solver._projection)
    eigh_buckets = sum(bucket_method(projection, i) == "eigh" and bk.n > 1
                       for i, bk in enumerate(solver.structure.buckets))
    for rec in runner.recordings.values():
        assert len(rec.parts) == eigh_buckets


def test_batched_plain_replay_matches_run_chunk():
    """BatchedSDPSolver's step (eigh, a leading instance axis of 3) through
    the runner and through run_chunk."""
    base = _certified()
    rng = np.random.default_rng(4)
    probs = [dataclasses.replace(base, C_vals=base.C_vals * (1.0 + 0.2 * i) + 0.05 * rng.standard_normal(
        len(base.C_vals))) for i in range(3)]
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=10, switch_admm=4, normal_solver="precond")
    batch = BatchedSDPSolver(probs, cfg, device="cpu")
    step = step_mod.make_step(stop_tol=0.0, switch_admm=4, sig_update_threshold=cfg.sig_update_threshold,
                              sig_update_stage_1=cfg.sig_update_stage_1, sig_min=cfg.sig_min, sig_max=cfg.sig_max)
    runner = _runner_vs_eager(step, batch.params, batch._initial_states(cfg.sig), [6, 6])
    assert set(runner.recordings) == {True, False}
    res = batch.solve(max_iter=20, stop_tol=0.0)
    assert batch.chunk_runner == "plain" and all(r.iterations == 20 for r in res)


def test_returned_state_is_not_overwritten_by_the_next_chunk():
    solver = _solver(_certified())
    step = _step(solver)
    runner = step_mod.make_chunk_runner(step, solver.params)
    s1, rows1 = runner(_start(solver), 0, 5)
    kept = step_mod._clone(s1)
    s2, rows2 = runner(s1, 5, 5)
    _assert_same(s1, kept, "first chunk's state")
    assert s2 is not s1 and all(getattr(s2, f) is not getattr(runner.static, f) for f in FIELDS)
    assert not torch.equal(rows1, rows2)


def _forced_eager(monkeypatch):
    monkeypatch.setattr(step_mod, "eager_reason", lambda params, mesh: "forced eager for the comparison")


def _same_result(a, b):
    assert a.iterations == b.iterations and a.recoveries == b.recoveries
    for k in ("X", "y", "S"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k, v in a.info.items():
        if k != "total_time":
            assert np.array_equal(v, b.info[k], equal_nan=True), k


def test_step_key_holds_every_argument_of_make_step():
    """Steps made from equal arguments have equal keys (tensors and the
    mesh by identity, a per-bucket projection in any order); a change of
    any one argument changes the key."""
    base = dict(stop_tol=0.0, switch_admm=0, sig_update_threshold=0, sig_update_stage_1=50, sig_min=1e-3,
                sig_max=1e3, eig_rank=None, projection="jacobi", rp_hp=None, mesh=None)
    hp = tuple(torch.zeros(2) for _ in range(3))
    key = lambda **kw: step_mod.make_step(**dict(base, **kw)).key
    one = {0: "jacobi", 1: "eigh"}
    assert key() == key()
    assert key(projection=one) == key(projection=dict(reversed(one.items())))
    assert key(rp_hp=hp) == key(rp_hp=hp) != key(rp_hp=tuple(t.clone() for t in hp))
    changed = dict(stop_tol=1e-3, switch_admm=1, sig_update_threshold=1, sig_update_stage_1=51, sig_min=2e-3,
                   sig_max=2e3, eig_rank=2, projection=one, rp_hp=hp, mesh=object())
    assert set(changed) == set(base)
    keys = {key()} | {key(**{name: v}) for name, v in changed.items()}
    assert len(keys) == 1 + len(changed)


def test_a_config_change_between_solves_records_anew(monkeypatch):
    """A solve after ``solver.config`` changes an option the step closes
    over records a new runner (the old one is freed); a solve with the same
    options replays the old one. Both match the eager driver bit for bit."""

    def run():
        solver = _solver(_certified(), switch_admm=8)
        out = [solver.solve(max_iter=10, stop_tol=0.0)]
        runner = solver._runners.runner
        out.append(solver.solve(max_iter=10, stop_tol=0.0))
        same = solver._runners.runner is runner
        solver.config = solver.config.replace(switch_admm=3, sig_max=solver.config.sig_max / 2)
        out.append(solver.solve(max_iter=10, stop_tol=0.0))
        return solver, runner, same, out

    solver, runner, same, res = run()
    assert same and solver._runners.runner is not runner and not runner.recordings
    assert set(solver._runners.runner.recordings) == {True, False}
    _forced_eager(monkeypatch)
    eager = run()[3]
    for r, e in zip(res, eager):
        _same_result(r, e)


def test_two_solves_reuse_the_recordings_and_match_eager(monkeypatch):
    """Two solve() calls on one solver: the second replays the first's
    recordings, and neither result aliases the other; both equal the
    eager driver's, bit for bit."""
    prob = _grid()
    solver = _solver(prob, switch_admm=15)
    r1 = solver.solve(max_iter=30, stop_tol=0.0)
    X1 = r1.X.copy()
    assert solver.chunk_runner == "plain"
    runner = solver._runners.runner
    r2 = solver.solve(max_iter=25, stop_tol=0.0, sig=3.0)
    assert solver._runners.runner is runner
    assert np.array_equal(r1.X, X1)
    _forced_eager(monkeypatch)
    eager = _solver(prob, switch_admm=15)
    e1 = eager.solve(max_iter=30, stop_tol=0.0)
    e2 = eager.solve(max_iter=25, stop_tol=0.0, sig=3.0)
    assert eager.chunk_runner == "eager"
    _same_result(r1, e1)
    _same_result(r2, e2)


def test_recovery_swaps_the_step_and_matches_eager(monkeypatch):
    """tests/test_torch_solver.py's probation setup: a poisoned factor, a
    level-1 recovery given back the good factor, 5 chunks of eigh, then
    jacobi again: each swap makes a new runner over the new step and
    parameters and frees the one it replaces; the result equals the eager
    driver's."""
    restart = driver.SDPSolver._recovery_restart

    def run():
        s = _solver(_grid(), check_every=4, switch_admm=10**9)
        good = s.params.neq
        bad = dataclasses.replace(good.factor, inv_l=torch.full_like(good.factor.inv_l, float("nan")))
        s.params = dataclasses.replace(s.params, neq=dataclasses.replace(good, factor=bad))

        def restart_and_repair(self, state, level):
            out = restart(self, state, level)
            self.params = dataclasses.replace(self.params, neq=dataclasses.replace(good, applies=good.applies + 2))
            return out

        monkeypatch.setattr(driver.SDPSolver, "_recovery_restart", restart_and_repair)
        return s, s.solve(max_iter=1 + 7 * 4, stop_tol=0.0)

    s, res = run()
    assert res.recoveries == 1 and s.chunk_runner == "plain"
    # The last runner is the configured (jacobi) step's, over the repaired parameters.
    runner = s._runners.runner
    assert runner.params is s.params and runner.step.key == _step(s).key
    _forced_eager(monkeypatch)
    _, eager = run()
    _same_result(res, eager)


@pytest.mark.parametrize("mode", ["cg", "host"])
def test_eager_modes_run_run_chunk_and_say_so(mode):
    solver = _solver(_certified(), normal_solver=mode)
    res = solver.solve(max_iter=12, stop_tol=0.0)
    assert res.iterations == 12 and solver.chunk_runner == "eager"
    assert solver._runners.reason.startswith(mode) and solver._runners.runner is None
    assert step_mod.eager_reason(solver.params, object()).startswith("mesh")


def test_replay_adds_the_launches_a_capture_counted(monkeypatch):
    """Replays add the kernel launches their recording made, and nothing
    else, once a chunk (``count``, times the chunk's replays); the counts
    are the one dict the wrappers increment (trace.COUNTS), so a caller
    that resets it (chip_smoke.py) sees the replays' launches."""
    monkeypatch.setitem(COUNTS, "k1", 0)
    monkeypatch.setitem(COUNTS, "k3", 0)
    before = dict(COUNTS)
    rec = step_mod._Recording(plain=lambda: torch.zeros(8), counts=dict(k1=4, k3=3))
    for _ in range(5):
        rec.replay()
    rec.count(5)
    after = dict(COUNTS)
    assert after["k1"] == 20 and after["k3"] == 15
    assert {k: after[k] - before[k] for k in ("k2", "k4", "k4_f32")} == {"k2": 0, "k4": 0, "k4_f32": 0}


def test_one_chunk_matches_jax_make_chunk_runner():
    """One chunk of cuadmm_tpu's make_chunk_runner (jit of a scan) and the
    port's runner from the same converted state: info rows and state to
    atol 1e-9 (precond, eigh and 4 sweeps pinned, as in
    tests/test_torch_step.py), across the sGS/ADMM switch."""
    jax = pytest.importorskip("jax")
    from cuadmm_tpu import SDPSolver as JSolver
    from cuadmm_tpu import SolverConfig as JConfig
    from cuadmm_tpu.models.random_sdp import random_certified_sdp as jrandom_certified_sdp
    from cuadmm_tpu.solver.step import make_chunk_runner as jmake_chunk_runner
    from cuadmm_tpu.solver.step import make_step as jmake_step

    from cuadmm_tpu_torch import convert

    switch, chunk = 6, 12
    cfg = JConfig(verbose=False, normal_solver="precond", projection="eigh", precond_applies=4, switch_admm=switch)
    prob, *_ = jrandom_certified_sdp([("s", 6), ("s", 3), ("u", 2), ("s", 1)], con_num=10, seed=11)
    js = JSolver(prob, cfg)
    rng = np.random.default_rng(5)
    st = js._initial_state(rng.standard_normal(prob.vec_len) * 0.3, rng.standard_normal(prob.con_num),
                           rng.standard_normal(prob.vec_len) * 0.3, 2.0)
    consts = dict(stop_tol=1e-6, switch_admm=switch, sig_update_threshold=cfg.sig_update_threshold,
                  sig_update_stage_1=cfg.sig_update_stage_1, sig_min=cfg.sig_min, sig_max=cfg.sig_max)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    cpu = torch.device("cpu")
    state_t = convert.state_from_numpy(to_np(st), cpu)
    params_t = convert.params_from_numpy(to_np(js.params), cpu)

    new_t, rows_t = step_mod.make_chunk_runner(step_mod.make_step(projection="eigh", **consts), params_t)(
        state_t, 0, chunk)
    new_j, rows_j = jmake_chunk_runner(jmake_step(projection="eigh", **consts), chunk)(st, js.params)
    assert tuple(rows_t.shape) == np.shape(rows_j) == (chunk, 8)
    np.testing.assert_allclose(rows_t.numpy(), np.asarray(rows_j), rtol=0, atol=1e-9)
    for f in FIELDS:
        a, b = np.asarray(getattr(new_j, f)), getattr(new_t, f).numpy()
        if np.issubdtype(a.dtype, np.integer):
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9, err_msg=f)


# ----------------------------------------------------------------------
# On the card: the CUDA graphs against the eager loop, bit for bit.
# ----------------------------------------------------------------------

CUDA_CASES = {
    "precond_jacobi_k1_k4": (lambda: _grid(8, 12), dict(switch_admm=6), {}, [10, 4]),
    "eigh_segments": (_grid, dict(projection="eigh"), {}, [6, 4]),
    "banded_k3": (lambda: _grid(8, 12), dict(normal_solver="banded"), {}, [5, 5]),
    "banded_k3_tiles": (lambda: _grid(8, 12), dict(normal_solver="banded"), {}, [5, 5]),
    "packed_k2": (lambda: _grid(8, 12), dict(normal_solver="packed"), {}, [5, 5]),
    "split_k1": (_quasar, dict(normal_solver="auto"), {}, [5, 5]),
    "dense": (_certified, dict(normal_solver="dense"), {}, [5, 5]),
    "f32_rp_hp": (_certified, dict(dtype="float32"), dict(rp_hp=True), [5, 5]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_graphs_match_eager_on_card(monkeypatch, case):
    """Each case's chunks through the graph runner and the eager loop, bit
    for bit. ``banded_k3`` runs the grid's band in K3's segments form,
    ``banded_k3_tiles`` with that form off, in K3's one-hop tile form."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    if case == "banded_k3_tiles":
        monkeypatch.setattr(tchol, "card_limits", lambda d: dataclasses.replace(tlim.card_limits(d), segment_model=None))
    make, cfg, opts, chunks = CUDA_CASES[case]
    solver = _solver(make(), device="cuda", **cfg)
    if case.startswith("banded"):
        tiles = isinstance(solver.params.neq.factor, tchol.BandFactor)
        assert tiles == (case == "banded_k3_tiles") and (not tiles or solver.params.neq.factor.form == "chain")
    step = _step(solver, **opts)
    state = _start(solver)
    step_mod.run_chunk(step, state, solver.params, 0, 1)  # builds every kernel before counting
    torch.cuda.synchronize()
    before = dict(COUNTS)
    runner = _runner_vs_eager(step, solver.params, state, chunks)
    torch.cuda.synchronize()
    assert runner.graphs and all(rec.plain is None for rec in runner.recordings.values())
    # The graph counters are the runner's alone.
    both = {k: v - before[k] for k, v in COUNTS.items() if not k.startswith("graph_")}
    # The runner's launches (its eager first iterations, then replays) and
    # run_chunk's are the same kernels: half of each count is the runner's.
    assert all(v % 2 == 0 for v in both.values()), both
    mode = solver.params.neq.mode
    kernel = {"precond": "k1", "split": "k1", "banded": "k3", "packed": "k2"}.get(mode)
    if isinstance(solver.params.neq.factor, tchol.SegmentFactor):
        kernel = "k3_seg"  # K3's segments form: one launch a sweep
    if kernel is not None:
        assert both[kernel] >= 2 * sum(chunks) * solver.params.neq.applies, (kernel, both)


@pytest.mark.cuda
def test_batched_graphs_match_eager_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = _grid(8, 12)
    probs = [dataclasses.replace(base, C_vals=base.C_vals * (1.0 + 0.2 * i)) for i in range(3)]
    cfg = cuadmm_tpu_torch.SolverConfig(verbose=False, check_every=10, switch_admm=4, normal_solver="precond")
    batch = BatchedSDPSolver(probs, cfg, device="cuda")
    step = step_mod.make_step(stop_tol=0.0, switch_admm=4, sig_update_threshold=cfg.sig_update_threshold,
                              sig_update_stage_1=cfg.sig_update_stage_1, sig_min=cfg.sig_min, sig_max=cfg.sig_max)
    _runner_vs_eager(step, batch.params, batch._initial_states(cfg.sig), [6, 6])
    res = batch.solve(max_iter=20, stop_tol=0.0)
    assert batch.chunk_runner == "graphs" and all(r.iterations == 20 for r in res)


@pytest.mark.cuda
def test_recovery_recaptures_on_card():
    """A poisoned factor's first chunk goes non-finite; the recovery swaps
    the step and the parameters, which frees the runner's graphs and
    captures new ones (into a new pool: the allocator refuses a capture
    into a pool whose graphs are all gone); the solve runs on as graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    s = _solver(_certified(), device="cuda", check_every=5, switch_admm=10**9)
    neq = s.params.neq
    bad = dataclasses.replace(neq.factor, inv_l=torch.full_like(neq.factor.inv_l, float("nan")))
    s.params = dataclasses.replace(s.params, neq=dataclasses.replace(neq, factor=bad))
    res = s.solve(max_iter=30, stop_tol=0.0)
    assert res.recoveries >= 1 and res.iterations == 30
    assert s.chunk_runner == ("eager" if s.params.neq.mode == "cg" else "graphs")
