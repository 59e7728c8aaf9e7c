"""K1, the fused y = M^T (M r): the port's wrapper, plain version and launch
plan, for one right-hand side and for a batch (B, n_pad) (K1 over B).

On the CPU the wrapper runs the plain version, held here against the JAX
package's Pallas kernel in interpret mode and the f64 dot pair, and the
launch plan is checked for its invariants up to n_pad 262,144. The CUDA
kernel itself runs only on a card: those tests are marked ``cuda`` and run
with ``python -m pytest --noconftest -m cuda tests/test_torch_precond_apply.py``
(the suite's conftest imports jax, which the card's machine lacks).
"""

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch.ops import precond_apply as tpa
from cuadmm_tpu_torch.trace import COUNTS

torch.set_num_threads(1)

REL_TOL = 1e-5  # f32 sums in another order (tests/test_ops.py:404)


def _factor(n, seed):
    """M = inv(L) for a well-conditioned lower-triangular L (its lower
    triangle: a general inverse leaves rounding above the diagonal), and an r."""
    rng = np.random.default_rng(seed)
    L = np.tril(rng.standard_normal((n, n))) + n * np.eye(n)
    return np.tril(np.linalg.inv(L)).astype(np.float32), rng.standard_normal(n).astype(np.float32)


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


@pytest.mark.parametrize("n", [100, 130, 517, 1000])
def test_apply_padded_matches_jax_interpret(n):
    """apply_padded (pad r to n_pad, K1, slice back) against the JAX
    apply_padded with its Pallas kernel in interpret mode, on an f64 r (cast
    to the factor's f32 as there); on the CPU no K1 launch is counted."""
    jpa = pytest.importorskip("cuadmm_tpu.ops.precond_apply")
    import jax.numpy as jnp

    M, _ = _factor(n, 4)
    r = np.random.default_rng(5).standard_normal(n)
    pallas = np.asarray(jpa.apply_padded(jpa.pad_factor(jnp.asarray(M)), jnp.asarray(r, jnp.float32), interpret=True))
    mp = tpa.pad_factor(torch.as_tensor(M))
    before = COUNTS["k1"]
    y = tpa.apply_padded(mp, torch.as_tensor(r))
    assert COUNTS["k1"] == before
    assert y.shape == (n,) and y.dtype == torch.float32
    assert _rel(y.numpy(), pallas) < REL_TOL
    ref = tpa.fused_spd_apply_ref(mp, torch.nn.functional.pad(torch.as_tensor(r, dtype=torch.float32),
                                                              (0, mp.shape[0] - n)))[:n]
    torch.testing.assert_close(y, ref, rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 2, 3, 8])
def test_plain_batch_is_the_stacked_rows_bit_for_bit(b):
    """A batch (B, n_pad) on the CPU: each row's plain result, stacked, bit
    for bit (the batched solver's CPU numbers do not move); no launch is
    counted."""
    M, _ = _factor(256, 8)
    m = torch.as_tensor(M)
    rr = torch.as_tensor(np.random.default_rng(b).standard_normal((b, 256)), dtype=torch.float32)
    before = (COUNTS["k1"], COUNTS["k1_rhs"])
    y = tpa.fused_spd_apply(m, rr)
    assert (COUNTS["k1"], COUNTS["k1_rhs"]) == before
    assert y.shape == (b, 256)
    assert torch.equal(y, torch.stack([tpa.fused_spd_apply(m, row) for row in rr]))
    assert torch.equal(y, torch.stack([m.T @ (m @ row) for row in rr]))


def test_cpu_tensors_launch_nothing():
    M, r = _factor(128, 1)
    before = COUNTS["k1"]
    y = tpa.fused_spd_apply(torch.as_tensor(M), torch.as_tensor(r))
    assert COUNTS["k1"] == before
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
        (torch.empty(303232, 303232, device="meta"), torch.empty(303232, device="meta"), ValueError),
        (torch.empty(128, 128, device="meta"), torch.empty(128), ValueError),  # devices differ
        (torch.empty(128, 128, device="meta"), torch.empty(128, device="meta"), ValueError),
        (torch.zeros(128, 128), torch.zeros(3, 127), ValueError),  # batch rows of the wrong length
        (torch.zeros(128, 128), torch.zeros(0, 128), ValueError),  # an empty batch
        (torch.zeros(128, 128), torch.zeros(2, 2, 128), ValueError),  # three axes
        (torch.zeros(128, 128), torch.zeros(3, 128, dtype=torch.float64), TypeError),
        (torch.zeros(128, 128), torch.zeros(128, 3).T, ValueError),  # a strided batch
    ],
    ids=["r_len", "square", "lane", "empty", "m_f64", "r_f16", "strided", "too_big",
         "mixed_devices", "meta_device", "batch_len", "batch_empty", "batch_3d", "batch_f64", "batch_strided"],
)
def test_wrapper_rejects(m, r, err):
    before = COUNTS["k1"]
    with pytest.raises(err):
        tpa.fused_spd_apply(m, r)
    assert COUNTS["k1"] == before


@pytest.mark.parametrize("n", [128, 130, 517])
def test_pad_factor_keeps_only_the_lower_triangle(n):
    """Whatever a triangular solve leaves above the diagonal, the padded
    factor is exactly zero there and row-major; the lower triangle is kept
    bit for bit."""
    a = torch.as_tensor(np.random.default_rng(n).standard_normal((n, n)), dtype=torch.float32)
    mp = tpa.pad_factor(a.T.contiguous().T)  # a column-major input, as cuSOLVER returns
    n_pad = mp.shape[0]
    assert n_pad % tpa.LANE == 0 and n_pad >= n and mp.is_contiguous()
    assert torch.equal(mp.triu(1), torch.zeros_like(mp))
    assert torch.equal(mp[:n, :n], torch.tril(a)) and not mp[n:].any() and not mp[:, n:].any()


def _h100_resident(cluster, rows, smem, rhs=1, warps=16):
    """Clusters an H100 (132 SMs) holds at once, as the occupancy query would
    say for one CTA an SM."""
    return 132 // cluster


# The kernel's static shared memory (the partials' inbox and its two
# mbarriers) and what one CTA of an H100 may use (227 KB).
STATIC_SMEM = 2 * 32 * (tpa.THREADS // 32) * 4 + 16
BLOCK_SMEM_LIMIT = 232_448


def _panel_steps(n_pad, plan, k):
    """The kernel's rule for cluster k's steps, as their first rows: pair j
    is p = k + j K, its steps panels p and P - 1 - p."""
    panels = n_pad // plan.rows
    out = []
    for p in range(k, panels // 2, plan.clusters):
        out += [p * plan.rows, (panels - 1 - p) * plan.rows]
    return out


def _member_chunks(chunks, cluster, member):
    """The kernel's ownership rule: slot u of member m lies in chunk
    m + (u // 32) * cluster."""
    return np.arange(member, chunks, cluster)


PLAN_SIZES = [128, 256, 1024, 5120, 17152, 24576, 24704, 32512, 44416, 65536, 131072, 196608, 262144]


@pytest.mark.parametrize("n_pad", PLAN_SIZES)
def test_launch_plan_invariants(n_pad):
    """Every chunk has one owner, members' shares of every row's triangle
    differ by at most one chunk, a CTA's row stages fit its shared memory
    (two or more in flight) and its threads' r and y their registers, the t
    exchange fits a warp, and the clusters' panel pairs
    cover every row once with equal steps and equal triangle work within
    one pair."""
    plan = tpa.launch_plan(n_pad, _h100_resident)
    c, r, chunks = plan.cluster, plan.rows, n_pad // tpa.LANE
    assert c in tpa.CLUSTER_SIZES and r in tpa.ROWS_PER_STEP and r * c <= 32
    owned = [_member_chunks(chunks, c, m) for m in range(c)]
    assert np.array_equal(np.sort(np.concatenate(owned)), np.arange(chunks))
    slice_bytes = max(len(o) for o in owned) * tpa.SLOT_BYTES
    assert 3 <= plan.stages <= tpa.MAX_STAGES
    assert plan.smem == plan.stages * r * slice_bytes <= tpa.MAX_SMEM
    assert plan.smem + STATIC_SMEM <= BLOCK_SMEM_LIMIT
    assert slice_bytes <= tpa.SLOTS_PER_THREAD[r] * tpa.THREADS * 16  # r and y fit the registers
    rows = np.unique(np.r_[np.linspace(0, n_pad - 1, 257).astype(np.int64), n_pad - 1])
    work = np.stack([
        np.clip(rows[:, None] + 1 - tpa.LANE * o[None, :], 0, tpa.LANE).sum(axis=1) for o in owned
    ])
    assert (work.max(axis=0) - work.min(axis=0)).max() <= tpa.LANE
    assert work.sum(axis=0).tolist() == (rows + 1).tolist()
    steps = [_panel_steps(n_pad, plan, k) for k in range(plan.clusters)]
    firsts = np.sort(np.concatenate(steps))
    assert np.array_equal(firsts, np.arange(0, n_pad, r))  # every panel once
    assert max(map(len, steps)) - min(map(len, steps)) <= 2 and min(map(len, steps)) >= 2
    tri = lambda row0: sum(row0 + i + 1 for i in range(r))  # a panel's entries
    pair_work = {tri(s[j]) + tri(s[j + 1]) for s in steps for j in range(0, len(s), 2)}
    assert len(pair_work) == 1  # p and P - 1 - p: every pair the same work
    assert 1 <= plan.clusters <= _h100_resident(c, r, plan.smem)


# The one-RHS plan as it was before K1 over B: (C, K, R, S, smem) at each
# PLAN_SIZES point under _h100_resident.
ONE_RHS_PLANS = {
    128: (1, 8, 8, 8, 32768), 256: (1, 16, 8, 8, 65536), 1024: (1, 64, 8, 6, 196608),
    5120: (1, 132, 2, 5, 204800), 17152: (1, 132, 1, 3, 205824), 24576: (2, 66, 1, 4, 196608),
    24704: (2, 66, 1, 4, 198656), 32512: (2, 66, 1, 3, 195072), 44416: (4, 33, 1, 5, 222720),
    65536: (4, 33, 1, 3, 196608), 131072: (8, 16, 1, 3, 196608), 196608: (16, 8, 1, 4, 196608),
    262144: (16, 8, 1, 3, 196608),
}


@pytest.mark.parametrize("n_pad", PLAN_SIZES)
def test_launch_plan_for_one_rhs_is_unchanged(n_pad):
    """B = 1 keeps the one-RHS kernel and its plan exactly."""
    plan = tpa.launch_plan(n_pad, _h100_resident, 1)
    assert plan == tpa.launch_plan(n_pad, _h100_resident)
    assert (plan.cluster, plan.clusters, plan.rows, plan.stages, plan.smem) == ONE_RHS_PLANS[n_pad]
    assert plan.rhs == 1 and plan.warps == tpa.THREADS // 32


# The B kernel's static shared memory (each warp's sums, the inbox of every
# member's sums for both groups, two mbarriers).
RHS_STATIC_SMEM = 2 * 2 * tpa.RHS_WARPS * 32 * 4 + 2 * 16 * 2 * 32 * 4 + 2 * 8


@pytest.mark.parametrize("b", [2, 3, 8, 11])
@pytest.mark.parametrize("n_pad", [128, 5120, 18816, 44416])
def test_rhs_plan_invariants(n_pad, b):
    """The groups cover the B right-hand sides in order, each launch at most
    its kernel's; each B-kernel launch: the largest member's chunks within
    its warps' slots (r and y in 128 registers a thread, 16 float4 each),
    R x BT <= 32 sums a warp (one a lane; the one-RHS kernel's R x C <= 32
    was one partial a lane, and here a member's warps push the CTA's sums
    instead), even R (the groups copy alternate rows), three or more stages
    and the static arrays within a CTA's shared memory, and panel pairs of
    equal work covering every row once."""
    groups = tpa.rhs_groups(n_pad, b)
    assert sum(nb for nb, _ in groups) == b and all(1 <= nb <= rhs for nb, rhs in groups)
    assert [rhs for _, rhs in groups if rhs > 1] == sorted((rhs for _, rhs in groups if rhs > 1), reverse=True)
    assert sum(1 for nb, _ in groups if nb == 1) <= 1  # one left over at most takes the one-RHS kernel
    for nb, rhs in groups:
        plan = tpa.launch_plan(n_pad, _h100_resident, rhs)
        assert plan.rhs == rhs
        if rhs == 1:
            assert plan == tpa.launch_plan(n_pad, _h100_resident)
            continue
        c, r, bt = plan.cluster, plan.rows, rhs // tpa.RHS_GROUPS
        group_warps = plan.warps // tpa.RHS_GROUPS
        chunks = -(-(n_pad // tpa.LANE) // c)
        assert c in tpa.CLUSTER_SIZES and 1 <= group_warps <= tpa.RHS_WARPS
        assert chunks <= group_warps * tpa.rhs_slots(rhs)
        assert 2 * 4 * tpa.rhs_slots(rhs) * bt == 128  # r and y registers a thread
        assert r in tpa.RHS_ROWS and r % 2 == 0 and r * bt <= 32
        assert tpa.RHS_MIN_STAGES <= plan.stages <= tpa.MAX_STAGES
        assert plan.smem == plan.stages * r * tpa.member_slice(n_pad, c) <= tpa.RHS_MAX_SMEM
        assert plan.smem + RHS_STATIC_SMEM <= BLOCK_SMEM_LIMIT
        steps = [_panel_steps(n_pad, plan, k) for k in range(plan.clusters)]
        assert np.array_equal(np.sort(np.concatenate(steps)), np.arange(0, n_pad, r))
        assert 1 <= plan.clusters <= _h100_resident(c, r, plan.smem)
    if b >= 8 and n_pad <= 18816:
        assert groups[0] == (8, 8)  # one read of the factor for eight instances
    if (n_pad, b) == (18816, 8):
        plan = tpa.launch_plan(n_pad, _h100_resident, 8)
        assert groups == ((8, 8),) and (plan.cluster, plan.rows, plan.warps) == (8, 4, 10)


def test_rhs_groups_serve_any_batch():
    """Every B up to 40 is served with the fewest factor reads the largest
    kernel allows; past the B kernel's n_pad, one launch a right-hand side."""
    for b in range(1, 41):
        groups = tpa.rhs_groups(18816, b)
        assert sum(nb for nb, _ in groups) == b
        assert len(groups) == (1 if b == 1 else -(-b // 8))
    assert tpa.rhs_groups(44416, 8) == ((4, 4), (4, 4))
    assert tpa.rhs_groups(44416, 3) == ((3, 4),)
    assert tpa.rhs_groups(262144, 3) == ((1, 1),) * 3 and not tpa.fits(262144, 2)
    assert tpa.rhs_groups(128, 1) == ((1, 1),)
    with pytest.raises(ValueError):
        tpa.launch_plan(262144, _h100_resident, 2)
    with pytest.raises(ValueError):
        tpa.launch_plan(18816, _h100_resident, 3)  # the kernel takes 2, 4 or 8


def test_launch_plan_rejects_what_the_kernel_cannot_take():
    for n_pad in (0, 130, tpa.MAX_N_PAD + tpa.LANE):
        with pytest.raises(ValueError):
            tpa.launch_plan(n_pad, _h100_resident)
    big = tpa.launch_plan(tpa.MAX_N_PAD, _h100_resident)
    assert big.cluster == tpa.CLUSTER_SIZES[-1] and big.smem <= tpa.MAX_SMEM


def _card_operands(n, seed):
    """M on the card: the inverse of a lower-triangular L up to n = 4224,
    past that a unit-diagonal random lower triangle made directly."""
    if n <= 4224:
        M, r = _factor(n, seed)
        return torch.as_tensor(M, device="cuda"), torch.as_tensor(r, device="cuda")
    from cuadmm_tpu_torch.k1_ab import unit_lower

    return unit_lower(n, seed)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1024, 4224, 5120, 44416])
def test_kernel_matches_plain_on_card(n):
    _needs_card()
    m, rv = _card_operands(n, 5)
    before = COUNTS["k1"]
    y = tpa.fused_spd_apply(m, rv)
    torch.cuda.synchronize()
    assert COUNTS["k1"] == before + 1
    ref = tpa.fused_spd_apply_ref(m.double(), rv.double())
    assert _rel(y.cpu(), ref.cpu()) < REL_TOL
    # Deterministic: partials are summed in a fixed order.
    assert torch.equal(tpa.fused_spd_apply(m, rv), y)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 5001])
def test_apply_padded_on_card(n):
    """apply_padded on the card: one K1 launch on the padded factor, within
    REL_TOL of the plain version on the same operands."""
    _needs_card()
    M, r = _factor(n, 6)
    mp = tpa.pad_factor(torch.as_tensor(M, device="cuda"))
    rv = torch.as_tensor(r, device="cuda")
    before = COUNTS["k1"]
    y = tpa.apply_padded(mp, rv)
    torch.cuda.synchronize()
    assert COUNTS["k1"] == before + 1 and y.shape == (n,)
    ref = tpa.fused_spd_apply_ref(mp.double(), torch.nn.functional.pad(rv.double(), (0, mp.shape[0] - n)))[:n]
    assert _rel(y.cpu(), ref.cpu()) < REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 5120, 33024])
def test_kernel_never_reads_the_strict_upper_triangle(n):
    """NaN above the diagonal: the kernel's result is finite, matches the
    plain version on the lower triangle and is bitwise repeatable."""
    _needs_card()
    m, rv = _card_operands(n, 7)
    ref = tpa.fused_spd_apply_ref(m.double(), rv.double())
    m.add_(torch.full_like(m, float("nan")).triu_(1))
    y = tpa.fused_spd_apply(m, rv)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    assert _rel(y.cpu(), ref.cpu()) < REL_TOL
    assert torch.equal(tpa.fused_spd_apply(m, rv), y)


def _card_batch(m, b, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, m.shape[0]), device="cuda", generator=gen)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1024, 5120, 18816, 44416])
def test_rhs_kernel_matches_plain_on_card(n):
    """K1 over B on the card, B in {2, 3, 8, 11}: one launch a group of
    ``rhs_groups`` serving B right-hand sides in all; each column within
    REL_TOL of the f64 plain version (the one-RHS test's tolerance);
    bitwise repeatable."""
    _needs_card()
    m, _ = _card_operands(n, 9)
    md = m.double()
    for b in (2, 3, 8, 11):
        rr = _card_batch(m, b, 10 + b)
        before = (COUNTS["k1"], COUNTS["k1_rhs"])
        y = tpa.fused_spd_apply(m, rr)
        torch.cuda.synchronize()
        assert (COUNTS["k1"] - before[0], COUNTS["k1_rhs"] - before[1]) == (len(tpa.rhs_groups(n, b)), b)
        assert y.shape == (b, n)
        ref = tpa.fused_spd_apply_ref(md, rr.double())
        for j in range(b):
            assert _rel(y[j].cpu(), ref[j].cpu()) < REL_TOL, (b, j)
        assert torch.equal(tpa.fused_spd_apply(m, rr), y)


@pytest.mark.cuda
def test_rhs_one_left_over_and_one_row_keep_the_one_rhs_kernel_on_card():
    """A batch of one, and the ninth right-hand side of nine, take the
    one-RHS kernel: bit for bit the 1-D call."""
    _needs_card()
    m, _ = _card_operands(18816, 11)
    rr = _card_batch(m, 9, 12)
    assert tpa.rhs_groups(18816, 9) == ((8, 8), (1, 1))
    y = tpa.fused_spd_apply(m, rr)
    assert torch.equal(y[8], tpa.fused_spd_apply(m, rr[8].clone()))
    assert torch.equal(tpa.fused_spd_apply(m, rr[:1].clone())[0], tpa.fused_spd_apply(m, rr[0].clone()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 5120, 33024])
def test_rhs_kernel_never_reads_the_strict_upper_triangle(n):
    """NaN above the diagonal, B = 8: finite, within REL_TOL of the plain
    version on the lower triangle, bitwise repeatable."""
    _needs_card()
    m, _ = _card_operands(n, 13)
    rr = _card_batch(m, 8, 14)
    ref = tpa.fused_spd_apply_ref(m.double(), rr.double())
    m.add_(torch.full_like(m, float("nan")).triu_(1))
    y = tpa.fused_spd_apply(m, rr)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all())
    for j in range(8):
        assert _rel(y[j].cpu(), ref[j].cpu()) < REL_TOL
    assert torch.equal(tpa.fused_spd_apply(m, rr), y)


@pytest.mark.cuda
def test_rhs_wrapper_rejects_a_misaligned_batch_on_card():
    _needs_card()
    m = torch.zeros(128, 128, device="cuda")
    rr = torch.zeros(2 * 128 + 1, device="cuda")[1:].view(2, 128)
    before = COUNTS["k1"]
    with pytest.raises(ValueError):
        tpa.fused_spd_apply(m, rr)
    assert COUNTS["k1"] == before
