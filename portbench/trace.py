"""One call under torch.profiler, reduced to what the per-layer readers need.

The device's operations (kernels, copies, memsets) come from the trace as
intervals on one time base with the host's operations. ``busy_s`` is the
length of their union, ``window_s`` the traced call's wall time, and the
idle gaps are the stretches of the window that no device operation
covers, each named by the innermost host operation that spans its middle.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

WINDOW_SPAN = "portbench.traced_call"
TOP = 10  # entries in each list of the breakdown


@dataclasses.dataclass
class Trace:
    device_ops: List[Tuple[str, float, float]]  # (name, start_us, end_us), by start
    host_ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]  # the traced call's span, us
    window_s: float  # the traced call's wall time, on the trace's clock
    busy_s: float
    iterations: int

    def device_s(self, patterns: Optional[Sequence[str]] = None) -> float:
        """Seconds of device operations whose name matches one of the
        regular expressions ``patterns`` (all of them if None)."""
        rx = None if patterns is None else _pattern(patterns)
        return sum(e - s for n, s, e in self.device_ops if rx is None or rx.search(n)) / 1e6

    def layer_s(self, layers: Dict[str, Sequence[str]]) -> Dict[str, float]:
        """Seconds of device operations by layer, each operation in the
        first of ``layers`` (in order) with a pattern its name matches, and
        under "unmatched" those no layer matches."""
        rxs = [(k, _pattern(pats)) for k, pats in layers.items()]
        out = dict.fromkeys([k for k, _ in rxs] + ["unmatched"], 0.0)
        for n, s, e in self.device_ops:
            out[next((k for k, rx in rxs if rx.search(n)), "unmatched")] += (e - s) / 1e6
        return out

    def unmatched_ops(self, layers: Dict[str, Sequence[str]]) -> List[List]:
        """The TOP device operations by time that no layer's patterns match."""
        rx = _pattern([p for pats in layers.values() for p in pats])
        total: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            if not rx.search(n):
                total[n] = total.get(n, 0.0) + (e - s) / 1e6
        return [[short_name(n), t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def count(self, pattern: str) -> int:
        rx = _pattern([pattern])
        return sum(1 for n, _, _ in self.device_ops if rx.search(n))

    def top_ops(self) -> List[List]:
        total: Dict[str, float] = {}
        for n, s, e in self.device_ops:
            total[n] = total.get(n, 0.0) + (e - s) / 1e6
        return [[short_name(n), t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """The TOP longest stretches of the window with no device operation,
        each named by the innermost host operation the trace has at its
        middle, or else by where it lies in the call (the program's own
        Python, such as the host build of a solve's initial state, is not
        traced)."""
        gaps = []
        at = self.window[0]
        for s, e in _union(self.device_ops):
            if s > at:
                gaps.append((at, min(s, self.window[1])))
            at = max(at, e)
        if at < self.window[1]:
            gaps.append((at, self.window[1]))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:TOP]:
            mid = 0.5 * (a + b)
            spans = [(e - s, n) for n, s, e in self.host_ops if s <= mid <= e]
            if spans:
                name = short_name(min(spans)[1])
            elif a == self.window[0]:
                name = "host before the call's first device op"
            elif b == self.window[1]:
                name = "host after the call's last device op"
            else:
                name = "host between device ops, no traced op"
            out.append([name, (b - a) / 1e6])
        return out


def _pattern(patterns: Sequence[str]) -> "re.Pattern":
    """Any of the regular expressions ``patterns``, case ignored."""
    return re.compile("|".join(f"(?:{p})" for p in patterns), re.IGNORECASE)


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type, cut to
    160 characters."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # drop the argument list: the first "(" outside the template
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    if name.startswith("void "):
        name = name[5:]
    return name.strip()[:160]


def _union(ops) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for _, s, e in ops:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def capture(fn: Callable[[], int], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` (which returns the iterations it ran) under torch.profiler,
    ``sync`` ending the traced window."""
    act = torch.profiler.ProfilerActivity
    activities = [act.CPU] + ([act.CUDA] if torch.cuda.is_available() else [])
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            iters = fn()
            sync()
    dev, host, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.name == WINDOW_SPAN:  # on the device's timeline too, as a user annotation
            if ev.device_type == torch.autograd.DeviceType.CPU:
                window = (s, e)
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                dev.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
    dev.sort(key=lambda t: t[1])
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
    dev = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in dev if e > window[0] and s < window[1]]
    busy_us = sum(e - s for s, e in _union(dev))
    return Trace(device_ops=dev, host_ops=host, window=window, window_s=(window[1] - window[0]) / 1e6,
                 busy_s=busy_us / 1e6, iterations=iters)
