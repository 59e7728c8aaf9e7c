"""One port step against one cuadmm_tpu step from identical state (f64).

The JAX solver builds the problem; its state and parameters are carried
across with cuadmm_tpu_torch.convert. Tolerance atol 1e-9: the port's
normal solve applies an f32 inverse factor, the JAX CPU solve an f64
cho_solve, both refined 4 sweeps against the exact AA^T.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from cuadmm_tpu import SDPSolver as JSolver
from cuadmm_tpu import SolverConfig
from cuadmm_tpu.models.random_sdp import random_certified_sdp
from cuadmm_tpu.solver.step import make_step as jmake_step

from cuadmm_tpu_torch import convert
from cuadmm_tpu_torch.solver.state import SolverState
from cuadmm_tpu_torch.solver.step import make_step as tmake_step

torch.set_num_threads(1)

CPU = torch.device("cpu")
SWITCH = 50
CFG = SolverConfig(
    verbose=False, normal_solver="precond", projection="eigh", precond_applies=4,
    switch_admm=SWITCH,
)


@pytest.fixture(scope="module")
def jax_solver():
    prob, *_ = random_certified_sdp([("s", 6), ("s", 3), ("u", 2), ("s", 1)], con_num=10, seed=11)
    return JSolver(prob, CFG)


# (it, prim_win, dual_win, best_kkt, stop_tol): sGS branch; the switch
# iteration; ADMM with a sigma update (it+1 = 101 = 1 mod sig_stage_2) and a
# new best iterate; the done guard engaged.
CASES = {
    "sgs": (3, 0, 0, np.inf, 1e-6),
    "at_switch": (SWITCH - 1, 4, 1, np.inf, 1e-6),
    "admm_sig_update": (100, 9, 2, 1e3, 1e-6),
    "done": (7, 0, 0, np.inf, 1e3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(jax_solver, case):
    it, pw, dw, best, stop_tol = CASES[case]
    s = jax_solver
    rng = np.random.default_rng(5)
    vec, con = s.problem.vec_len, s.problem.con_num
    st = s._initial_state(
        rng.standard_normal(vec) * 0.3, rng.standard_normal(con), rng.standard_normal(vec) * 0.3, 2.0
    )
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    st = dataclasses.replace(
        st, it=i32(it), prim_win=i32(pw), dual_win=i32(dw), best_kkt=jnp.asarray(best, jnp.float64),
        X_best=st.X * 0.5, y_best=st.y * 0.5, S_best=st.S * 0.5,
    )
    consts = dict(
        stop_tol=stop_tol, switch_admm=SWITCH, sig_update_threshold=CFG.sig_update_threshold,
        sig_update_stage_1=CFG.sig_update_stage_1, sig_min=CFG.sig_min, sig_max=CFG.sig_max,
    )
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    state_t = convert.state_from_numpy(to_np(st), CPU)
    params_t = convert.params_from_numpy(to_np(s.params), CPU)

    new_j, row_j = jmake_step(projection="eigh", **consts)(st, s.params)
    new_t, row_t = tmake_step(projection="eigh", **consts)(state_t, params_t, it)

    for f in dataclasses.fields(SolverState):
        a, b = np.asarray(getattr(new_j, f.name)), getattr(new_t, f.name).numpy()
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-9, err_msg=f.name)
    np.testing.assert_allclose(row_t.numpy(), np.asarray(row_j), rtol=0, atol=1e-9)
    assert int(new_t.it) == (it if case == "done" else it + 1)
    if case == "done":
        for f in dataclasses.fields(SolverState):
            assert torch.equal(getattr(new_t, f.name), getattr(state_t, f.name)), f.name
