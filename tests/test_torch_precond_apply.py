"""K1, the fused y = M^T (M r): the port's wrapper and plain version.

On the CPU the wrapper runs the plain version, held here against the JAX
package's Pallas kernel in interpret mode and the f64 dot pair. The CUDA
kernel itself runs only on a card: those tests are marked ``cuda`` and run
with ``python -m pytest --noconftest -m cuda tests/test_torch_precond_apply.py``
(the suite's conftest imports jax, which the card's machine lacks).
"""

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch.ops import precond_apply as tpa

torch.set_num_threads(1)

REL_TOL = 1e-5  # f32 sums in another order (tests/test_ops.py:404)


def _factor(n, seed):
    """M = inv(L) for a well-conditioned lower-triangular L, and an r."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    return np.linalg.inv(L).astype(np.float32), rng.standard_normal(n).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n", [128, 130, 517])
def test_plain_matches_pallas_interpret_and_dot_pair(n):
    jpa = pytest.importorskip("cuadmm_tpu.ops.precond_apply")
    import jax.numpy as jnp

    M, r = _factor(n, 3)
    dot_pair = M.astype(np.float64).T @ (M.astype(np.float64) @ r.astype(np.float64))
    pallas = np.asarray(jpa.apply_padded(jpa.pad_factor(jnp.asarray(M)), jnp.asarray(r), interpret=True))
    mp = tpa.pad_factor(torch.as_tensor(M))
    assert mp.shape[0] % tpa.LANE == 0 and mp.shape[0] >= n
    rp = torch.nn.functional.pad(torch.as_tensor(r), (0, mp.shape[0] - n))
    y = tpa.fused_spd_apply(mp, rp)[:n].numpy()
    assert y.shape == (n,)
    assert _rel(y, dot_pair) < REL_TOL
    assert _rel(y, pallas) < REL_TOL


def test_cpu_tensors_launch_nothing():
    M, r = _factor(128, 1)
    before = tpa.LAUNCHES
    y = tpa.fused_spd_apply(torch.as_tensor(M), torch.as_tensor(r))
    assert tpa.LAUNCHES == before
    torch.testing.assert_close(y, tpa.fused_spd_apply_ref(torch.as_tensor(M), torch.as_tensor(r)))


@pytest.mark.parametrize(
    "m,r,err",
    [
        (torch.zeros(128, 128), torch.zeros(127), ValueError),  # r length
        (torch.zeros(128, 256), torch.zeros(128), ValueError),  # not square
        (torch.zeros(130, 130), torch.zeros(130), ValueError),  # not a multiple of 128
        (torch.zeros(0, 0), torch.zeros(0), ValueError),  # empty
        (torch.zeros(128, 128, dtype=torch.float64), torch.zeros(128), TypeError),
        (torch.zeros(128, 128), torch.zeros(128, dtype=torch.float16), TypeError),
        (torch.zeros(256, 256)[::2, ::2], torch.zeros(128), ValueError),  # not contiguous
        (torch.empty(32896, 32896, device="meta"), torch.empty(32896, device="meta"), ValueError),
        (torch.empty(128, 128, device="meta"), torch.empty(128), ValueError),  # devices differ
        (torch.empty(128, 128, device="meta"), torch.empty(128, device="meta"), ValueError),
    ],
    ids=["r_len", "square", "lane", "empty", "m_f64", "r_f16", "strided", "too_big",
         "mixed_devices", "meta_device"],
)
def test_wrapper_rejects(m, r, err):
    before = tpa.LAUNCHES
    with pytest.raises(err):
        tpa.fused_spd_apply(m, r)
    assert tpa.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1024, 4224])
def test_kernel_matches_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    M, r = _factor(n, 5)
    m, rv = torch.as_tensor(M, device="cuda"), torch.as_tensor(r, device="cuda")
    before = tpa.LAUNCHES
    y = tpa.fused_spd_apply(m, rv)
    torch.cuda.synchronize()
    assert tpa.LAUNCHES == before + 1
    ref = tpa.fused_spd_apply_ref(m.double(), rv.double())
    assert _rel(y.cpu(), ref.cpu()) < REL_TOL
    # Deterministic: partials are summed in a fixed order.
    assert torch.equal(tpa.fused_spd_apply(m, rv), y)
