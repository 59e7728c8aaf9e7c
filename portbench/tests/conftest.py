"""Fixtures of the benchmark's tests. Run them from the root of the
repository: ``python -m pytest portbench/tests``; those marked cuda need
the card and skip without it."""

from __future__ import annotations

import shutil

import pytest

from portbench_tiny import REPO, add_tiny_cell, run_copy as _run_copy


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of BENCHMARK.json and portbench/ with the tiny cell added."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cell(tmp_path)
    return tmp_path


@pytest.fixture
def run_copy():
    """``run_copy(root, plant="", trace=False, device="cpu")``."""
    return _run_copy


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
