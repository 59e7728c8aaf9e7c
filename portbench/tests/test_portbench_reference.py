"""The plain reference against the program's CPU path at a tiny size: the
same sGS iterations from the same cold start."""

from __future__ import annotations

import json
import sys
import warnings
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from portbench import compare  # noqa: E402
from portbench.generators import quasar, toroidal_maxcut  # noqa: E402
from portbench.reference.sgs_admm import Reference  # noqa: E402

CONFIGS = REPO / "portbench" / "configs"
SETTINGS = json.loads((CONFIGS / "gset_g11_chordal.json").read_text())["solver"]
QUASAR = json.loads((CONFIGS / "quasar500.json").read_text())["generator_params"]
CASES = {
    "chordal": lambda: toroidal_maxcut.generate({"rows": 10, "cols": 4}, 2**31 + 1),
    "quasar": lambda: quasar.generate(dict(QUASAR, n_poses=5), 2**31 + 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("switch_admm", [50_000, 120])
def test_reference_follows_the_programs_cpu_path(case, switch_admm):
    from portbench.entries import sdp_solve

    prob = CASES[case]()
    settings = dict(SETTINGS, dtype="float64", switch_admm=switch_admm)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = Reference(prob, settings, "cpu").solve(200, 0.0)
    res = sdp_solve.build(prob, settings, "cpu").solve(200, 0.0)
    assert res["failure"] is None and ref["iterations"] == res["iterations"] == 200
    gaps = compare.gaps(res, ref)
    # The program's normal solve refines to a 1e-10 relative residual
    # (1e-12 on its dense CPU path); the reference solves directly.
    assert gaps["iterate_gap"] < 1e-7 and gaps["info_gap"] < 1e-7, gaps
