"""Calibrated projection dispatch of the port against cuadmm_tpu.ops.dispatch,
on temporary tables (tests/test_dispatch.py's cases) and the committed ones."""

import json
import os

import pytest

from cuadmm_tpu_torch.ops import dispatch as tdisp


def _write_table(data_dir, backend, dtype, rows):
    with open(os.path.join(data_dir, f"eig_sweep_{backend}_{dtype}.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.fixture
def both(tmp_path, monkeypatch):
    """The port's and the JAX package's loaders, pointed at one throwaway
    table directory."""
    jdisp = pytest.importorskip("cuadmm_tpu.ops.dispatch")
    monkeypatch.setattr(jdisp, "_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(tdisp, "_DATA_DIR", str(tmp_path))
    return tmp_path, jdisp


@pytest.mark.parametrize(
    "rows,buckets,expected",
    [
        (
            [
                {"n": 8, "batch": 64, "eigh_ms": 1.0, "poly_ms": 0.2},
                {"n": 128, "batch": 64, "eigh_ms": 5.0, "poly_ms": 9.0},
                {"n": 512, "batch": 1, "eigh_ms": 50.0, "poly_ms": 20.0},
            ],
            [(1, 100), (10, 50), (100, 80), (600, 1)],
            {0: "clamp", 1: "poly", 2: "eigh", 3: "poly"},
        ),
        (
            [
                {"n": 4, "batch": 512, "eigh_ms": 3.0, "poly_ms": 1.0, "jacobi_ms": 0.5},
                {"n": 64, "batch": 8, "eigh_ms": 2.0, "poly_ms": 4.0},
            ],
            [(4, 500), (64, 8)],
            {0: "jacobi", 1: "eigh"},
        ),
    ],
    ids=["nearest_neighbour", "jacobi"],
)
def test_choose_methods_matches_jax(both, rows, buckets, expected):
    data_dir, jdisp = both
    _write_table(data_dir, "fake", "float64", rows)
    assert tdisp.choose_methods(buckets, "fake", "float64") == expected
    assert jdisp.choose_methods(buckets, "fake", "float64") == expected


def test_missing_table(both):
    _, jdisp = both
    assert tdisp.choose_methods([(8, 4)], "nosuchbackend", "float64") is None
    assert jdisp.choose_methods([(8, 4)], "nosuchbackend", "float64") is None


def test_jacobi_never_past_the_kernel(both):
    """K4 takes every block size, so no bucket is past it: where the nearest
    row of an n=80 bucket picks jacobi, both packages pick jacobi."""
    data_dir, jdisp = both
    rows = [{"n": 64, "batch": 8, "eigh_ms": 2.0, "poly_ms": 3.0, "jacobi_ms": 1.0},
            {"n": 256, "batch": 8, "eigh_ms": 9.0, "poly_ms": 4.0}]
    _write_table(data_dir, "fake", "float64", rows)
    buckets = [(64, 8), (80, 8), (128, 56), (300, 8)]
    expected = {0: "jacobi", 1: "jacobi", 2: "jacobi", 3: "poly"}
    assert tdisp.choose_methods(buckets, "fake", "float64") == expected
    assert jdisp.choose_methods(buckets, "fake", "float64") == expected


def test_committed_tables():
    """The CPU table is the JAX package's; the CUDA table, swept on the card,
    times every method at every point (jacobi where n <= 64)."""
    jdisp = pytest.importorskip("cuadmm_tpu.ops.dispatch")
    assert tdisp.load_sweep("cpu", "float64") == jdisp.load_sweep("cpu", "float64")
    rows = tdisp.load_sweep("cuda", "float64")
    assert rows, "cuadmm_tpu_torch/data/eig_sweep_cuda_float64.jsonl is missing"
    for r in rows:
        assert {"eigh_ms", "poly_ms"} <= set(r) and r["dtype"] == "float64"
        assert ("jacobi_ms" in r) == (r["n"] <= 64)
    grid = [(4, 80), (8, 598), (16, 182), (32, 49), (64, 11)]
    out = tdisp.choose_methods(grid, "cuda", "float64")
    assert set(out) == set(range(len(grid))) and set(out.values()) <= set(tdisp.METHODS)


def test_eig_sweep_needs_the_card():
    """The sweep times the card: without CUDA it stops before timing anything."""
    import torch

    from cuadmm_tpu_torch import eig_sweep

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    with pytest.raises(SystemExit, match="cuda"):
        eig_sweep.main(["--dtype", "float64"])
