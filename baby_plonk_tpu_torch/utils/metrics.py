"""Spans and counters of the port (counterpart of
``baby_plonk_tpu/utils/metrics.py``; SURVEY.md §5: the reference has
println! + Instant only, prover.rs:107,157). ``get_metrics()`` is the
process's one recorder.

``Metrics.span`` times a region and adds its duration under its name in
``durations``. PyTorch returns before the device finishes, so a span that
should include its device work is opened with ``sync=True`` and waits for
the card before it reads the clock.

While ``torch.profiler`` records, or while ``keep_records`` is set, a span
also appends a ``SpanRecord`` (name, proof id, parent, start, end, size) to
``records`` and opens a ``torch.profiler.record_function`` range of its
name, which puts it on the profiler's clock beside the device's intervals.
Otherwise it keeps no record and opens no range. ``size`` is what the
caller passes as ``span(..., size=...)``, the call's count of elements, or
None: a work count per call reads it.

Spans of the ops layer with a size:

- ``msm.pippenger``: each variable-base Pippenger MSM
  (``ops/msm_pippenger.py::msm_pippenger``), size n, the points; under
  ``prover.commit`` in a prove. Not synced: on the card it times the host's
  part (the digits, the sort's launch, the plan, the scratch, the launch);
  on the CPU the plain version's whole work.

``Prover.prove`` runs inside ``proof()``, which numbers the proofs of the
process: the spans of a prove carry its id, spans outside one (set-up)
carry None.

Counters (``count``), each counted where the work happens:

- ``h2d_bytes``: bytes copied from host data to the device
  (``ops/limbs.py::to_device``);
- ``host_syncs``: each time the host waits for the device: a read of
  device data (``limbs.to_host``), and a blocking copy up from pageable
  memory, which PyTorch ends with a stream synchronize
  (``c10::cuda::memcpy_and_sync``), so it waits for every launch before it;
- ``device_columns``: round 1's wire columns gathered on the device, 3 a
  prove on a device engine (``ops/torch_engine.py::wire_columns``), 0 where
  the host engine builds them in Python;
- ``witness_order_hits`` and ``witness_order_misses``: +1 each time round
  1's witness is read on a device engine, by the native pass over the dict
  in the key order its program's wire table learned (a hit), or by one
  lookup a name (a miss: another order, the first witness, no native
  reader) (``ops/torch_engine.py::wire_columns``);
- ``pippenger_msms`` and ``pippenger_points``: +1 and +n at each
  variable-base Pippenger MSM over n points (``ops/msm_pippenger.py::
  msm_pippenger``), 9 calls a prove on that commit path, 0 on the
  fixed-base one;
- ``horner_groups`` and ``horner_lanes``: +P G and +P W (lanes a window)
  at each fixed-base Horner launch of P scalar sets over G groups
  (``ops/msm_fixed.py::msm_fixed_horner``), a lane being a slice of K
  groups of one chunk: their ratio is K / W, how far the launch shares
  its doublings (K > 1) or splits its bits (W > 1).

All count whatever the device is, the CPU's included.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from collections import defaultdict
from dataclasses import dataclass

import torch
from torch.profiler import record_function


@dataclass(slots=True)
class SpanRecord:
    name: str
    #: the prove's id (``Metrics.proof``), None outside a prove
    proof: int | None
    #: index in ``Metrics.records`` of the span this one opened inside, or None
    parent: int | None
    #: ``time.perf_counter`` seconds
    start: float
    end: float = 0.0
    #: the call's count of elements (``span(..., size=...)``), or None
    size: int | None = None


class Metrics:
    def __init__(self):
        self.durations: dict[str, float] = defaultdict(float)
        self.counters: dict[str, int] = defaultdict(int)
        self.records: list[SpanRecord] = []
        #: keep records without a profiler (tests, ad hoc breakdowns)
        self.keep_records = False
        self.proof_id: int | None = None
        self._proof_ids = itertools.count()
        self._open: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False, size: int | None = None):
        rec = None
        if self.keep_records or torch.autograd._profiler_enabled():
            rng = record_function(name)
            rng.__enter__()
            rec = len(self.records)
            self.records.append(SpanRecord(name, self.proof_id, self._open[-1] if self._open else None, 0.0,
                                           size=size))
            self._open.append(rec)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _device_sync()
            t1 = time.perf_counter()
            self.durations[name] += t1 - t0
            if rec is not None:
                if self._open and self._open[-1] == rec:  # else a reset dropped it
                    self._open.pop()
                    self.records[rec].start, self.records[rec].end = t0, t1
                rng.__exit__(None, None, None)

    @contextlib.contextmanager
    def proof(self):
        """Number one prove: the spans inside carry the next proof id."""
        outer, self.proof_id = self.proof_id, next(self._proof_ids)
        try:
            yield self.proof_id
        finally:
            self.proof_id = outer

    def count(self, name: str, inc: int = 1):
        self.counters[name] += inc

    def reset(self):
        """Zero the accumulators and drop the records (e.g. between a cold
        and a warm prove so the warm per-round breakdown isn't buried in
        first-use set-up). Proof ids keep counting."""
        self.durations.clear()
        self.counters.clear()
        self.records.clear()
        self._open.clear()

    def report(self) -> str:
        parts = [f"{k}={v*1e3:.1f}ms" for k, v in sorted(self.durations.items())]
        parts += [f"{k}={v}" for k, v in sorted(self.counters.items())]
        return " ".join(parts)


def _device_sync() -> None:
    """Wait for the CUDA device, where the process has initialised one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_global = Metrics()


def get_metrics() -> Metrics:
    return _global
