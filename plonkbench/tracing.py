"""The traced run: torch.profiler over the whole measured window, reduced
to what the per-layer readers and the breakdown need.

From the benchmark's own files, in the traced run only: every
``utils.metrics`` span of the port also opens a ``record_function`` range
of its name, the harness marks the window, each prove and each proof's
serialization the same way, and each commit of the fixed-base method
records its shape (the sets and the longest scalar array), which the work
count of the Horner launch reads. The port is not edited.

A device interval is a kernel, a copy or a set that the profiler's CUDA
trace holds (not the ranges it projects onto the device's timeline). The
device is busy where any interval covers the time; an idle gap is labelled
by the innermost range open on the host at its midpoint (a long gap is the
host preparing the next launch, so its start would name the range that
made the last one).
"""
from __future__ import annotations

import bisect
import contextlib
import re
import sys
import time
from dataclasses import dataclass, field

WINDOW = "plonkbench.window"
PROVE = "plonkbench.prove"
TO_BYTES = "plonkbench.to_bytes"


def short_name(name: str) -> str:
    """A kernel's name without its namespaces' markers, template and
    argument lists: ``void (anonymous namespace)::msm_fixed_kernel(...)``
    -> ``msm_fixed_kernel``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep, 1)[0]
    return name.strip() or "?"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: int
    #: short name -> (count, seconds) over the window
    by_name: dict = field(default_factory=dict)
    #: (seconds, label) of every idle gap inside the window
    gaps: list = field(default_factory=list)
    #: (P, k, chunk) of each commit of the fixed-base method in the window
    commits: list = field(default_factory=list)


class Tracer:
    """Installs the ranges and the commit recorder, and runs the profiler."""

    def __init__(self, cuda: bool = True):
        import torch
        from torch.profiler import ProfilerActivity, record_function

        self.torch = torch
        self.cuda = cuda
        self.activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.record_function = record_function
        self.commits: list = []
        self._span_names: set = set()
        self._prof = None

    def install(self) -> None:
        from baby_plonk_tpu_torch.ops import msm_fixed
        from baby_plonk_tpu_torch.utils import metrics

        span, rf, names = metrics.Metrics.span, self.record_function, self._span_names

        @contextlib.contextmanager
        def traced_span(obj, name, *args, **kwargs):
            names.add(name)
            with rf(name), span(obj, name, *args, **kwargs):
                yield

        metrics.Metrics.span = traced_span
        msm_many, commits = msm_fixed.FixedBaseTables.msm_many, self.commits

        def recorded(tables, scalars_list, *args, **kwargs):
            commits.append((len(scalars_list), max(s.shape[-1] for s in scalars_list), tables.chunk))
            return msm_many(tables, scalars_list, *args, **kwargs)

        msm_fixed.FixedBaseTables.msm_many = recorded

    def range(self, name: str):
        return self.record_function(name)

    def warm_up(self) -> None:
        """A first, short profile: CUPTI's start-up belongs to set-up."""
        from torch.profiler import profile

        with profile(activities=self.activities):
            self.torch.zeros(1, device="cuda" if self.cuda else "cpu").sum().item()

    def start(self) -> None:
        from torch.profiler import profile

        self.commits.clear()
        self._prof = profile(activities=self.activities)
        self._prof.__enter__()

    def stop(self) -> Trace:
        if self.cuda:
            self.torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        t = time.perf_counter()
        trace = reduce(self._prof.profiler.kineto_results.events(), self._span_names | {PROVE, TO_BYTES})
        trace.commits = list(self.commits)
        print(f"plonkbench: trace reduced in {time.perf_counter() - t:.2f} s", file=sys.stderr)
        return trace


def reduce(events, range_names: set) -> Trace:
    """The window's device intervals, busy time, idle gaps and kernel totals."""
    from torch.autograd import DeviceType

    window = None
    ranges, device = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name in range_names or name == WINDOW:
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
        elif name == WINDOW:
            window = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name in range_names:
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if window is None:
        raise RuntimeError("the trace holds no window range")
    lo, hi = window
    device = sorted((max(s, lo), min(t, hi), n) for s, t, n in device if t > lo and s < hi)
    by_name: dict = {}
    for s, t, n in device:
        c, sec = by_name.get(short_name(n), (0, 0.0))
        by_name[short_name(n)] = (c + 1, sec + (t - s) / 1e9)
    busy, gaps_at, cur = 0, [], lo
    for s, t, _ in device:
        if s > cur:
            gaps_at.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if hi > cur:
        gaps_at.append((cur, hi))
    ranges.sort()
    gaps = [((t - s) / 1e9, _label(ranges, (s + t) // 2)) for s, t in gaps_at]
    return Trace(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9, device_ops=len(device), by_name=by_name, gaps=gaps)


def _label(ranges: list, at: int) -> str:
    """The innermost range (latest start) open at ``at``; ranges sorted by start."""
    i = bisect.bisect_right(ranges, (at, float("inf"), ""))
    best = None
    for s, t, n in reversed(ranges[max(0, i - 256) : i]):
        if s <= at < t:
            best = n
            break
    return best or "harness loop"


def breakdown(trace: Trace) -> dict:
    """The line's ``breakdown``: the 10 device operations that took the most
    time, and the 10 longest idle gaps by what the host was doing."""
    ops = sorted(((n, sec) for n, (_, sec) in trace.by_name.items()), key=lambda r: -r[1])[:10]
    gaps = sorted(trace.gaps, key=lambda g: -g[0])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[label, s] for s, label in gaps]}
