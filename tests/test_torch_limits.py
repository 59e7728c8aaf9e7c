"""The card's limits (cuadmm_tpu_torch/ops/limits.py) and where they are
read: ``limits_for`` over card sizes, ``card_limits`` on CUDA only, the
accelerator branch of ``auto`` and the factor builds taking the card's
numbers, and precond/split raising before they allocate past the card's
n_pad."""

import dataclasses

import numpy as np
import pytest
import torch

from cuadmm_tpu_torch.ops import chol as tchol
from cuadmm_tpu_torch.ops import limits as lim
from cuadmm_tpu_torch.ops import sparse as tsparse
from cuadmm_tpu_torch.ops import tri_stream as tts

torch.set_num_threads(1)

CPU = torch.device("cpu")
H100_BYTES = 85_017_493_504  # total_memory of an NVIDIA H100 80GB HBM3 (card_fit.py)
SIZES = (2 * 10**9, 8 * 10**9, 16 * 10**9, 40 * 10**9, H100_BYTES, 141 * 10**9, 192 * 10**9)


def test_limits_are_monotone_in_the_card_memory():
    rows = [lim.limits_for(t) for t in SIZES]
    for field in ("packed_max_con", "band_max_bytes", "dense_a_budget", "precond_max_n_pad"):
        vals = [getattr(r, field) for r in rows]
        assert vals == sorted(vals) and vals[-1] > vals[0], field


@pytest.mark.parametrize("total", SIZES)
def test_each_peak_fits_at_its_limit_and_not_one_step_past(total):
    lm, avail = lim.limits_for(total), lim.available(total)
    assert avail == int(total * (1 - lim.HEADROOM))
    # packed: one more block row of 1024 constraints
    assert lim.PACKED_PEAK(lim.packed_bytes(lm.packed_max_con)) <= avail
    assert lim.PACKED_PEAK(lim.packed_bytes(lm.packed_max_con + lim.PACKED_BLOCK)) > avail
    assert lim.packed_bytes(lm.packed_max_con) == tts.make_layout(max(lm.packed_max_con, 1)).T * 4 * 1024**2
    # banded: one more byte
    assert lim.BAND_PEAK(lm.band_max_bytes) <= avail < lim.BAND_PEAK(lm.band_max_bytes + 1)
    # precond: one more lane of 128 rows (three f32 squares of n_pad)
    n = lm.precond_max_n_pad
    assert n % lim.LANE == 0
    assert lim.PRECOND_PEAK(4.0 * n * n) <= avail < lim.PRECOND_PEAK(4.0 * (n + lim.LANE) ** 2)
    assert lm.dense_a_budget == int(avail - lim.PRECOND_PEAK.constant)
    assert lm.band_model == lim.BAND_MODEL


def test_h100_limits():
    """The H100's numbers PERF.md quotes: precond to n_pad 79,872 (the
    20x80 grid's 44,416 well inside), the packed triangle to 191,488
    constraints, a 72.7 GB band (derived tiles included)."""
    lm = lim.limits_for(H100_BYTES)
    assert (lm.precond_max_n_pad, lm.packed_max_con) == (79872, 191488)
    assert 72.6e9 < lm.band_max_bytes < 72.7e9
    assert tchol.dense_a_fits(44312, 61476, 4, lm.dense_a_budget)  # the 20x80 grid: 26.6 GB
    assert not tchol.dense_a_fits(44312, 61476, 4, 6 * 1024**3)  # the JAX package's 6 GiB


def test_card_limits_reads_the_cuda_device(monkeypatch):
    with pytest.raises(ValueError, match="CUDA"):
        lim.card_limits(CPU)
    props = lambda device: type("Props", (), {"total_memory": H100_BYTES})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    assert lim.card_limits("cuda:0") == lim.limits_for(H100_BYTES)


def test_band_model_form():
    """2 (T B^2 4 / bytes_per_s + T tile_s + nb (step_s + B row_s)) for
    each of K3's forms; the JAX package's TPU model is the same form
    without the step terms."""
    m = lim.BandModel(bytes_per_s=1e12, tile_s=1e-7, step_s=1e-6, row_s=1e-9)
    assert m(10, 512, 4) == pytest.approx(2 * (10 * 512 * 512 * 4 / 1e12 + 10 * 1e-7 + 4 * (1e-6 + 512e-9)))
    # one_hop: its own terms for the bands of nbw <= NBW_CHAIN (T / nb - 1).
    two = lim.BandModel(bytes_per_s=1e12, tile_s=1e-7, step_s=1e-6, row_s=1e-9,
                        one_hop=lim.BandModel(bytes_per_s=3e12, tile_s=0.0, step_s=2e-6, row_s=0.0))
    assert two(10, 512, 5) == pytest.approx(2 * (10 * 512 * 512 * 4 / 3e12 + 5 * 2e-6))  # nbw 1
    assert two(25, 512, 5) == pytest.approx(2 * (25 * 512 * 512 * 4 / 3e12 + 5 * 2e-6))  # nbw 4
    assert two(30, 512, 5) == pytest.approx(m(30, 512, 5))  # nbw 5: the two-hop terms
    # max_bytes: a band whose derived tiles do not fit is timed in the two-hop form it runs.
    held = lim.band_held_bytes(10, 512, 5, "chain")
    assert held == 2 * lim.band_held_bytes(10, 512, 5, "two_hop") == 20 * 512 * 512 * 4  # nbw 1: T + 2 nb nbw
    assert dataclasses.replace(two, max_bytes=held)(10, 512, 5) == pytest.approx(two(10, 512, 5))
    assert dataclasses.replace(two, max_bytes=held - 1)(10, 512, 5) == pytest.approx(m(10, 512, 5))
    card = lim.limits_for(H100_BYTES)
    assert card.bound_band_model() == dataclasses.replace(lim.BAND_MODEL, max_bytes=card.band_max_bytes)
    jax_form = lim.BandModel(bytes_per_s=800e9, tile_s=3e-6, step_s=0.0, row_s=0.0)
    for n, bw in ((68350, 4), (112028, 1615), (154256, 20512), (5000, 300), (1342, 4)):
        assert tts.make_band_layout(n, bw, model=jax_form) == tts.make_band_layout(
            n, bw, model=lambda T, B, nb: T * B * B * 4 / 800e9 + T * 3e-6)


def _jax_limits():
    return lim.CardLimits(total_bytes=16 * 10**9, packed_max_con=73_000, band_max_bytes=int(14.2 * 2**30),
                          dense_a_budget=6 * 1024**3, precond_max_n_pad=32768,
                          band_model=lim.BandModel(800e9, 3e-6, 0.0, 0.0))


@pytest.mark.parametrize(
    "con_num,bw,jax_mode,card_mode",
    [
        (80000, 79999, "cg", "packed"),  # past the JAX package's 73,000: the card holds its 13.3 GB triangle
        (154256, 20512, "banded", "banded"),  # PushBox N=30's 13.9 GB band fits both
        (200000, 60000, "cg", "banded"),  # a 47.6 GB band: only the card's 71.9 GB ceiling holds it
        (68350, 4, "banded", "banded"),  # the 20x120 grid
        (300000, 299999, "cg", "cg"),  # neither fits either card
    ],
)
def test_accelerator_branch_reads_the_cards_numbers(con_num, bw, jax_mode, card_mode):
    assert tchol.past_ceiling_mode(con_num, bw, True, 1, _jax_limits()) == jax_mode
    assert tchol.past_ceiling_mode(con_num, bw, True, 1, lim.limits_for(H100_BYTES)) == card_mode


def _chain_operands(con_num: int = 300):
    """A chain A (each row couples with its neighbour) and its f64 tables."""
    rows = np.repeat(np.arange(con_num), 2)
    cols = np.stack([np.arange(con_num), np.arange(1, con_num + 1)], 1).reshape(-1)
    vals = np.random.default_rng(0).standard_normal(2 * con_num)
    args = (cols, rows, vals, con_num, con_num + 1)
    return args, tsparse.build_sparse_a(*args, torch.float64, CPU)


def test_build_takes_card_limits_on_cuda(monkeypatch):
    """A CUDA device's build reads card_limits(device) before anything else
    (here a sentinel raises there); cg and host read none."""
    args, sa = _chain_operands()
    seen = []

    def card(device):
        seen.append(device)
        raise LookupError("card_limits")

    monkeypatch.setattr(tchol, "card_limits", card)
    for mode in ("auto", "precond", "banded", "packed", "split", "dense"):
        with pytest.raises(LookupError):
            tchol.build_normal_solver(*args, sa, mode, torch.float64, torch.device("cuda"))
    assert len(seen) == 6
    tchol.build_normal_solver(*args, sa, "cg", torch.float64, CPU)
    assert len(seen) == 6


def test_auto_past_the_ceiling_reads_the_limits_it_is_given():
    """_resolve_auto's accelerator branch takes the limits passed in: the
    same chain problem past dense_chol_max goes packed or banded by them."""
    args, _ = _chain_operands(3000)
    cut = dataclasses.replace(_jax_limits(), packed_max_con=0)
    mode, aat, probe = tchol._resolve_auto(*args, torch.float64, True, 1000, 1, _jax_limits())
    assert mode == "packed" and aat is not None and probe[0] == 1  # a 3-block triangle beats the band
    mode, _, _ = tchol._resolve_auto(*args, torch.float64, True, 1000, 1, cut)
    assert mode == "banded"
    mode, _, _ = tchol._resolve_auto(*args, torch.float64, False, 1000, 1, None)
    assert mode == "cg"


@pytest.mark.parametrize("mode", ["precond", "split"])
def test_inverse_factor_past_the_cards_n_pad_raises_before_building(mode, monkeypatch):
    """precond (and split's coupled prefix) past precond_max_n_pad raise
    worded like sharded's check, before the factorization starts; one lane
    fewer builds."""
    args, sa = _chain_operands(300)  # every row couples: split's prefix is all 300 rows, n_pad 384
    calls = []
    real = tchol._jitter_cholesky
    monkeypatch.setattr(tchol, "_jitter_cholesky", lambda *a, **k: calls.append(1) or real(*a, **k))
    small = dataclasses.replace(_jax_limits(), precond_max_n_pad=256)
    with pytest.raises(ValueError, match=f"normal_solver='{mode}'.*three f32 squares of n_pad 384"):
        tchol.build_normal_solver(*args, sa, mode, torch.float64, CPU, limits=small, applies=2)
    assert not calls
    fits = dataclasses.replace(small, precond_max_n_pad=384)
    neq = tchol.build_normal_solver(*args, sa, mode, torch.float64, CPU, limits=fits, applies=2)
    assert neq.mode == mode and calls


def test_dense_a_budget_routes_aat():
    """Dense A on the device when A, AA^T and its clone fit the budget,
    else the host's sparse product; no budget (the CPU) always dense."""
    args, sa = _chain_operands(300)
    need = (300 * 301 + 2 * 300 * 300) * 4
    for budget, where in ((need, "device"), (need - 1, "host"), (None, "device")):
        timings = {}
        l, _ = tchol._device_factorize(*args, 1e-5, CPU, torch.float32, budget, timings)
        assert timings["aat"] == where and torch.isfinite(l).all()
    assert tchol.dense_a_fits(300, 301, 4, need) and not tchol.dense_a_fits(300, 301, 4, need - 1)
