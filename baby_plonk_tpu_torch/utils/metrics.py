"""Lightweight tracing/metrics of the port (counterpart of
``baby_plonk_tpu/utils/metrics.py``; SURVEY.md §5: the reference has
println! + Instant only, prover.rs:107,157).

``span`` times a region; ``Metrics`` accumulates named durations and
counters and renders a one-line report. PyTorch returns before the device
finishes, so a span that should include its device work is opened with
``sync=True`` and waits for the card before it reads the clock.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict


class Metrics:
    def __init__(self):
        self.durations: dict[str, float] = defaultdict(float)
        self.counters: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        trace = os.environ.get("BPT_TRACE_SPANS")
        if trace:
            print(f"[span] {name} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _device_sync()
            dt = time.perf_counter() - t0
            self.durations[name] += dt
            if trace:
                print(f"[span] {name} {dt:.2f}s", file=sys.stderr, flush=True)
            if os.environ.get("BPT_TRACE_HBM"):
                import torch

                if torch.cuda.is_available():
                    used = torch.cuda.memory_allocated()
                    peak = torch.cuda.max_memory_allocated()
                    print(
                        f"[hbm] {name}: in_use={used/2**30:.2f}G "
                        f"peak={peak/2**30:.2f}G",
                        file=sys.stderr,
                        flush=True,
                    )
                else:
                    print(f"[hbm] {name}: no CUDA device", file=sys.stderr)

    def count(self, name: str, inc: int = 1):
        self.counters[name] += inc

    def reset(self):
        """Zero the accumulators (e.g. between a cold and a warm prove so
        the warm per-round breakdown isn't buried in first-use set-up)."""
        self.durations.clear()
        self.counters.clear()

    def report(self) -> str:
        parts = [f"{k}={v*1e3:.1f}ms" for k, v in sorted(self.durations.items())]
        parts += [f"{k}={v}" for k, v in sorted(self.counters.items())]
        return " ".join(parts)


def _device_sync() -> None:
    """Wait for the CUDA device, where the process has initialised one."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_global = Metrics()


def get_metrics() -> Metrics:
    return _global
