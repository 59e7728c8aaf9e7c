"""BENCHMARK.json keeps the contract's shape, and every entry has its file."""

from __future__ import annotations

import importlib.util
import json
import re

from portbench_tiny import REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
PKG = REPO / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") and ".." not in p
                                                for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(_line(w) and not w.startswith("/") and ".." not in w
                                             for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_the_contract_keys_names_and_units():
    names = []
    for section, (required, optional) in KEYS.items():
        for entry in MAN[section]:
            assert required <= set(entry) <= required | optional, (section, entry)
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            if "why" in entry:
                assert _line(entry["why"])
    for section in KEYS:
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got)), section
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_configs_and_cells():
    cells = {w["name"]: w for w in MAN["workloads"]}
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(cells) <= 24
    for cfg in MAN["configs"]:
        assert _line(cfg["source"]) and len(cfg["reduced"]) <= 16
        assert all(NAME.match(k) for k in cfg["reduced"])
        assert (REPO / cfg["file"]).is_file() and cfg["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        body = json.loads((REPO / cfg["file"]).read_text())
        assert body["name"] == cfg["name"] and body["source"] == cfg["source"]
        assert (PKG / "generators" / f"{body['generator']}.py").is_file()
        assert (PKG / "reference" / f"{body['reference']}.py").is_file()
        assert any(w["config"] == cfg["name"] for w in cells.values()), cfg["name"]
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    configs = {c["name"] for c in MAN["configs"]}
    for name, cell in cells.items():
        assert cell["config"] in configs and cell["chips"] in (1, 4) and NAME.match(cell["traffic"])
        wl = json.loads((PKG / "workloads" / f"{name}.json").read_text())
        assert wl["name"] == name and wl["config"] == cell["config"]
        assert (PKG / "entries" / f"{wl['entry']}.py").is_file()
        assert wl["dtype"] in ("float64", "float32")
        assert set(wl["limits"]) and all(v > 0 for v in wl["limits"].values())
    assert sum(c["chips"] == 4 for c in cells.values()) <= max(1, len(cells) // 4)


def test_metrics_have_readers_and_each_cell_reports_enough():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        spec = importlib.util.spec_from_file_location("reader", PKG / "metrics" / f"{m['name']}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        reported = [m for m in MAN["end_to_end"] if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in MAN["per_layer"])


def test_layer_files():
    for path in (PKG / "layers").glob("*.json"):
        body = json.loads(path.read_text())
        assert NAME.match(path.stem) and isinstance(body["rank"], int) and body["kernels"]
        for pat in body["kernels"]:
            re.compile(pat)


def test_files_under_paths_are_named_from_name_characters():
    for path in PKG.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
