"""svec <-> pool maps of the port against cuadmm_tpu.ops.svec (exact)."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from cuadmm_tpu.ops import svec as jsvec

from cuadmm_tpu_torch.ops import svec as tsvec
from cuadmm_tpu_torch.structure import BlockStructure

torch.set_num_threads(1)

# 1x1, free, pow2-padded and (with pack_to) packed buckets.
MIXED_BLK = [("s", 1), ("s", 3), ("u", 4), ("s", 5), ("s", 1), ("s", 2), ("s", 7), ("s", 3)]
CPU = torch.device("cpu")


@pytest.mark.parametrize("rounding,pack_to", [("pow2", 0), ("exact", 0), ("pow2", 8)])
def test_pool_maps_match_jax(rounding, pack_to):
    st = BlockStructure(MIXED_BLK, rounding, 64, pack_to)
    x = np.random.default_rng(3).standard_normal(st.vec_len)
    jm = jsvec.device_maps(st, jnp.float64)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    assert tm["pool_len"] == st.pool_len and tm["free_base"] == st.free_base

    pj = np.asarray(jsvec.pool_from_svec(jnp.asarray(x), jm))
    pt = tsvec.pool_from_svec(torch.as_tensor(x), tm).numpy()
    np.testing.assert_array_equal(pt, pj)
    assert pt.shape == (st.pool_len,)

    # Round trip: off-diagonals go through x/sqrt(2)*sqrt(2), one rounding
    # each, identically on both sides.
    rt = tsvec.svec_from_pool(torch.as_tensor(pt), tm).numpy()
    np.testing.assert_array_equal(rt, np.asarray(jsvec.svec_from_pool(jnp.asarray(pj), jm)))
    np.testing.assert_allclose(rt, x, rtol=4e-16, atol=0)
    # pool -> svec from an arbitrary pool vector.
    p = np.random.default_rng(4).standard_normal(st.pool_len)
    np.testing.assert_array_equal(
        tsvec.svec_from_pool(torch.as_tensor(p), tm).numpy(),
        np.asarray(jsvec.svec_from_pool(jnp.asarray(p), jm)),
    )


def test_device_maps_tables_match_jax():
    st = BlockStructure(MIXED_BLK, "pow2", 64, 8)
    jm = jsvec.device_maps(st, jnp.float64)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    for bj, bt in zip(jm["buckets"], tm["buckets"]):
        for k, v in bj.items():
            if isinstance(v, jsvec.Static):
                assert bt[k] == v.value, k
            else:
                np.testing.assert_array_equal(bt[k].numpy(), np.asarray(v), err_msg=k)
                if bt[k].dtype.is_floating_point is False:
                    assert bt[k].dtype == torch.int64, k


@pytest.mark.parametrize("rounding,pack_to", [("pow2", 0), ("exact", 0), ("pow2", 8)])
def test_blocks_match_jax(rounding, pack_to):
    """svec_to_blocks and blocks_to_svec against the JAX functions, exactly:
    off-diagonals / sqrt(2) in and * sqrt(2) out, padding zero, the free
    entries taken from X; the round trip returns X."""
    st = BlockStructure(MIXED_BLK, rounding, 64, pack_to)
    x = np.random.default_rng(5).standard_normal(st.vec_len)
    jm = jsvec.device_maps(st, jnp.float64)
    tm = tsvec.device_maps(st, torch.float64, CPU)
    bj = jsvec.svec_to_blocks(jnp.asarray(x), jm)
    bt = tsvec.svec_to_blocks(torch.as_tensor(x), tm)
    assert len(bt) == len(bj) == len(st.buckets)
    for mine, theirs, bk in zip(bt, bj, st.buckets):
        assert tuple(mine.shape) == (bk.count, bk.n, bk.n)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(mine.numpy(), np.swapaxes(mine.numpy(), 1, 2))  # symmetric
    # back from other blocks (each bucket scaled), the free entries from another X
    x2 = np.random.default_rng(6).standard_normal(st.vec_len)
    scaled = [b * (k + 2.0) for k, b in enumerate(bt)]
    got = tsvec.blocks_to_svec(scaled, torch.as_tensor(x2), tm).numpy()
    want = np.asarray(jsvec.blocks_to_svec([jnp.asarray(b.numpy()) for b in scaled], jnp.asarray(x2), jm))
    np.testing.assert_array_equal(got, want)
    rt = tsvec.blocks_to_svec(bt, torch.as_tensor(x), tm).numpy()
    np.testing.assert_array_equal(rt, np.asarray(jsvec.blocks_to_svec(bj, jnp.asarray(x), jm)))
    np.testing.assert_allclose(rt, x, rtol=4e-16, atol=0)
    free = np.asarray(st.free_pos)
    assert len(free) and np.array_equal(got[free], x2[free])
