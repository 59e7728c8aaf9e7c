"""Run one cell once: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name: the manifest (``BENCHMARK.json``
beside this package), ``workloads/<cell>.json``, the configuration file
the manifest names, ``generators/<generator>.py``, ``entries/<entry>.py``,
``reference/<reference>.py``, ``metrics/<metric>.py`` (every per-layer
metric, and an end-to-end one other than it_per_s, setup_s and
peak_mem_gib) and ``layers/<layer>.json``. Nothing here belongs to one
cell or one metric.

The window loops over whole solves from the cold start, each
``workload["max_iter"]`` iterations at the configuration's ``stop_tol``,
on one program object built in set-up; it holds the solves started before
``seconds`` ran out and ends with a device sync after the last. Set-up
(from the process's start) covers the problem's generation, the program's
build and one warm solve of one chunk (``check_every`` iterations), which
builds and records everything a solve of the window runs. A checkout's
first run also compiles the program's kernels into ``build/``: its
``build`` line names what it built, and such a run's ``setup_s`` is not
one a bound can hold.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

from portbench import compare
from portbench import trace as trace_mod

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cuadmm_tpu")  # top-level module names, compared whole
TRACE_ITER = 150  # iterations of the traced solve: three chunks, a trace that reduces in seconds
CARD_FIELDS = ("name", "power.limit", "power.draw", "clocks.sm", "clocks.max.sm", "clocks.mem",
               "temperature.gpu", "clocks_throttle_reasons.active")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(man: dict, name: str) -> tuple:
    """Cell ``name``'s workload file, its configuration file, and the
    solver settings of both with the workload's dtype."""
    wl = load_json(PKG / "workloads" / f"{name}.json")
    cfg = load_json(ROOT / find(man["configs"], find(man["workloads"], name, "workload")["config"],
                                "configuration")["file"])
    return wl, cfg, dict(cfg["solver"], **wl.get("solver", {}), dtype=wl["dtype"])


def load_metric(name: str):
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_patterns() -> dict:
    """Each layer's kernel patterns (``layers/<layer>.json``), in the order
    of their ``rank``: a kernel belongs to the first layer it matches."""
    files = [(load_json(p), p.stem) for p in sorted((PKG / "layers").glob("*.json"))]
    return {stem: d["kernels"] for d, stem in sorted(files, key=lambda t: (t[0]["rank"], t[1]))}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_record(device) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=1,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(device)))
    return dict(platform="cpu", kind=platform.processor() or platform.machine(), count=1, memory_peak_bytes=0)


def card_state() -> Optional[dict]:
    """The card's power limit, draw, clocks, temperature and throttle
    reasons by nvidia-smi, or None where it cannot say."""
    for fields in (CARD_FIELDS, CARD_FIELDS[:2]):
        try:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={','.join(fields)}", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=20)
        except (OSError, subprocess.TimeoutExpired):
            return None
        values = out.stdout.strip().splitlines()[:1]
        if out.returncode == 0 and values:
            return dict(zip(fields, (v.strip() for v in values[0].split(","))))
    return None


def host_state() -> dict:
    """Where the process runs: the cores it may use, the one it ran on
    last, the load, and torch's threads."""
    try:
        with open("/proc/self/stat") as f:
            last_core = int(f.read().rsplit(")", 1)[1].split()[36])
    except (OSError, IndexError, ValueError):
        last_core = None
    return dict(cores_allowed=len(os.sched_getaffinity(0)), last_core=last_core, loadavg=os.getloadavg(),
                torch_threads=torch.get_num_threads())


class GcPauses:
    """The garbage collector's pauses inside its with-block: (generation, seconds)."""

    def __init__(self):
        self.pauses, self._t = [], 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses.append((info["generation"], time.perf_counter() - self._t))

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


def built_kernels() -> set:
    """The program's kernel libraries in the checkout's ``build/``."""
    return {p.name for p in (ROOT / "build").glob("lib*.so")}


def note(key: str, obj) -> None:
    """An earlier line of the run's output: ``key {json}``."""
    print(f"{key} {json.dumps(obj, default=str)}", flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None) -> tuple:
    """One run of cell ``name``: (exit code, result dict or None)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    man = manifest()
    wl, cfg, settings = load_cell(man, name)
    max_iter, stop_tol = int(wl["max_iter"]), float(settings["stop_tol"])
    note("start", dict(cell=name, seed=seed, since_process_start=time.perf_counter() - t_start,
                       host=host_state()))
    built_before = built_kernels()

    # -- set-up ---------------------------------------------------------
    t0 = time.perf_counter()
    generator = importlib.import_module(f"portbench.generators.{cfg['generator']}")
    prob = generator.generate(cfg["generator_params"], seed)
    generate_s = time.perf_counter() - t0
    note("problem", dict(name=prob.name, con_num=prob.con_num, vec_len=prob.vec_len, blocks=len(prob.blk),
                         at_nnz=len(prob.At_vals), generate_s=generate_s))
    entry = importlib.import_module(f"portbench.entries.{wl['entry']}")
    t0 = time.perf_counter()
    program = entry.build(prob, settings, device)
    sync(device)
    solver_init_s = time.perf_counter() - t0
    note("init", dict(solver_init_s=solver_init_s, init_breakdown=program.init_breakdown))
    t0 = time.perf_counter()
    warm = program.solve(int(settings["check_every"]), stop_tol)
    sync(device)
    note("warm solve", dict(seconds=time.perf_counter() - t0, iterations=warm["iterations"],
                            failure=warm["failure"], facts=program.facts()))
    setup_s = time.perf_counter() - t_start
    built = sorted(built_kernels() - built_before)
    note("build", dict(first_run_of_checkout=bool(built), built=built))

    # -- the window -----------------------------------------------------
    runner0, recorded0 = program.captures()
    results, ends, cpu = [], [], [sum(os.times()[:2])]
    with GcPauses() as gc_pauses:
        t0 = time.perf_counter()
        while not results or time.perf_counter() - t0 < seconds:
            results.append(program.solve(max_iter, stop_tol))
            ends.append(time.perf_counter() - t0)
            cpu.append(sum(os.times()[:2]))
        sync(device)
        window_s = time.perf_counter() - t0
    card = card_state() if device.type == "cuda" else None
    runner1, recorded1 = program.captures()
    captures = recorded1 - recorded0 if runner1 is runner0 else recorded1
    dev = device_record(device)
    iterations = sum(r["iterations"] for r in results)
    failures = [r["failure"] for r in results if r["failure"]]
    if card is not None:
        note("card", dict(card, right_after_the_window=True))
    note("window", dict(seconds=window_s, solves=len(results), iterations=iterations, captures=captures,
                        runner_replaced=runner1 is not runner0, failures=failures,
                        solve_s=[b - a for a, b in zip([0.0] + ends, ends)],
                        solve_cpu_s=[b - a for a, b in zip(cpu, cpu[1:])], gc_pauses=gc_pauses.pauses,
                        host=host_state()))
    end_to_end = dict(
        it_per_s=iterations / window_s,
        setup_s=setup_s,
        peak_mem_gib=dev["memory_peak_bytes"] / 2**30,
    )

    # -- the trace and the per-layer metrics ----------------------------
    metrics = {}
    breakdown = None
    if trace:
        t0 = time.perf_counter()
        tr = trace_mod.capture(lambda: program.solve(min(TRACE_ITER, max_iter), stop_tol)["iterations"],
                               lambda: sync(device))
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        layers = layer_patterns()
        # What a per-layer metric's reader (metrics/<name>.py, read(ctx))
        # is given: the trace and its device seconds by layer, the program
        # and its facts, the card's name, the workload, the set-up's times.
        ctx = SimpleNamespace(trace=tr, layer_s=tr.layer_s(layers), program=program, facts=program.facts(),
                              kind=dev["kind"], device=device, workload=wl, stop_tol=stop_tol,
                              solver_init_s=solver_init_s, generate_s=generate_s, sync=lambda: sync(device))
        note("layers", dict(iterations_traced=tr.iterations, trace_and_reduction_s=time.perf_counter() - t0,
                            device_s=tr.device_s(), device_ops=len(tr.device_ops),
                            **ctx.layer_s, unmatched_ops=tr.unmatched_ops(layers)))
        for m in man["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        breakdown = dict(device_ops=tr.top_ops(), idle_gaps=tr.idle_gaps())
        note("per-layer metrics", dict(seconds=time.perf_counter() - t0))
    else:
        # An end-to-end metric the harness does not take itself has a reader
        # of its own, given the window's solves.
        window = SimpleNamespace(results=results, window_s=window_s, setup_s=setup_s, device=dev, workload=wl)
        for m in man["end_to_end"]:
            if name in m.get("workloads", [name]):
                value = end_to_end[m["name"]] if m["name"] in end_to_end else load_metric(m["name"]).read(window)
                if value is not None:
                    metrics[m["name"]] = dict(value=value, unit=m["unit"])

    # -- the check --------------------------------------------------------
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    ref = reference.Reference(prob, settings, device).solve(max_iter, stop_tol)
    checks = compare.judge(results, ref, wl["limits"])
    note("reference", dict(seconds=time.perf_counter() - t0, iterations=ref["iterations"]))
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4, None
    out = dict(correct=correct, attempted=len(results), failed=len(failures), metrics=metrics, device=dev)
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for key, c in checks.items():
        print(f"{key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0, out
