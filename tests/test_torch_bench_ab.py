"""cuadmm_tpu_torch/bench_ab.py on two stand-in checkouts whose
portbench/run.py prints a result line: the runs alternate parent, change,
change, parent over two seeds, each side runs in its own root, and the
medians are each side's."""

import json

from cuadmm_tpu_torch import bench_ab

RUN = """import argparse, json
ap = argparse.ArgumentParser()
for a in ("--workload", "--seed", "--seconds", "--trace"):
    ap.add_argument(a)
args = ap.parse_args()
rate = {rate} + int(args.seed) % 10
print("warm-up line")
print(json.dumps(dict(correct=True, metrics=dict(it_per_s=dict(value=rate, unit="it/s"),
                                                 setup_s=dict(value=1.5, unit="s")))))
"""


def _checkout(tmp_path, name, rate):
    root = tmp_path / name
    (root / "portbench").mkdir(parents=True)
    (root / "portbench" / "run.py").write_text(RUN.replace("{rate}", str(rate)))
    return root


def test_pairs_alternate_and_medians_are_per_side(tmp_path, capsys):
    parent, change = _checkout(tmp_path, "parent", 50), _checkout(tmp_path, "change", 90)
    out = tmp_path / "out"
    rc = bench_ab.main([str(parent), str(change), "--cells", "c1", "--seeds", "11,12", "--seconds", "1",
                        "--out", str(out)])
    assert rc == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    runs, medians = lines[:4], lines[4:]
    assert [(r["side"], r["seed"]) for r in runs] == [("parent", 11), ("change", 11), ("change", 12),
                                                      ("parent", 12)]
    assert [r["it_per_s"] for r in runs] == [51, 91, 92, 52]
    assert all(r["correct"] is True and r["setup_s"] == 1.5 and "peak_mem_gib" not in r for r in runs)
    assert medians == [dict(side="parent", medians={"c1": {"it_per_s": 51.5, "setup_s": 1.5}}),
                       dict(side="change", medians={"c1": {"it_per_s": 91.5, "setup_s": 1.5}})]
    assert (out / "change_c1_12.out").read_text().startswith("warm-up line")


def test_a_failed_run_gives_its_exit_code(tmp_path, capsys):
    parent, change = _checkout(tmp_path, "parent", 50), _checkout(tmp_path, "change", 90)
    (change / "portbench" / "run.py").write_text("raise SystemExit(3)\n")
    rc = bench_ab.main([str(parent), str(change), "--cells", "c1", "--seeds", "5", "--out", str(tmp_path / "o")])
    assert rc == 3
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert rows[1] == dict(rows[1], side="change", rc=3, correct=None)
    assert rows[-1] == dict(side="change", medians={"c1": {}})
