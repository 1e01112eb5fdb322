"""One cell's run: set-up, the measured window, the judgement of its proofs
by the plain reference, and the result line.

The port is driven through its public path only: the circuit's lines ->
``Program.from_strs`` -> ``Setup.generate_srs_device`` -> ``Prover(setup,
program, TorchEngine(device)).prove(witness, blinding=...)`` ->
``Proof.to_bytes``, with the port's defaults apart from the switches that
the configuration's ``env`` states. The harness also makes the NTT plans
itself in set-up (``ops.ntt.ntt_device``), to time them apart.

``Session`` holds what one process sets up for a cell; ``run_cell`` is one
benchmark run; ``plonkbench/readings.py`` reuses a session for many seeds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from dataclasses import dataclass, field

from plonkbench import tracing
from plonkbench.reference.plonk import ELEMENTS, Prepared, check
from plonkbench.spec import Cell

#: top-level modules that may not be loaded in a run (compared whole: the
#: port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "baby_plonk_tpu")
#: what the reference compares, by kind
KINDS = {"wrong_commitments": ("a_1", "b_1", "c_1", "z_1", "t_sum", "t_lo_1", "t_mid_1", "t_hi_1"),
         "wrong_evaluations": ("a_bar", "b_bar", "c_bar", "s1_bar", "s2_bar", "z_omega_bar"),
         "wrong_openings": ("w_zeta_1", "w_zeta_omega_1")}
assert sorted(sum(KINDS.values(), ())) == sorted(ELEMENTS)
#: faults that the harness can plant under the timed path (controls and tests)
FAULTS = ("unblinded", "unsplit", "stale", "altered")

clock = time.perf_counter


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What one run measured; the metric readers read its attributes."""

    setup_s: float = 0.0
    #: set-up's parts, seconds: library_s, srs_s, lines_s, keygen_s, pool_s, plan_s, cold_prove_s
    setup_parts: dict = field(default_factory=dict)
    window_s: float = 0.0
    latencies: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    proofs: int = 0
    peak_mem_bytes: int = 0
    #: the port's utils.metrics spans over the window, seconds
    spans: dict = field(default_factory=dict)
    trace: tracing.Trace | None = None
    #: the card's streaming multiprocessors (the work count's windows)
    sms: int = 0


def plan_seconds(ntt, n: int, dev, sync) -> float:
    """The prove sizes' NTT plans: for n and 4 n, each direction, the first
    transform's time less the second's (as ``baby_plonk_tpu_torch/bench.py``)."""
    import torch

    total = 0.0
    for size in (n, 4 * n):
        x = torch.zeros((16, 1, size), dtype=torch.int32, device=dev)
        for inverse in (False, True):
            times = []
            for _ in range(2):
                sync()
                t = clock()
                ntt.ntt_device(x, inverse)
                sync()
                times.append(clock() - t)
            total += times[0] - times[1]
    return total


class Session:
    """A cell's set-up in one process, in the benchmark's order: the
    library, the SRS, the program and proving key; then per seed the
    witness pool (``traffic``); the plans; and a cold prove (``warm``)."""

    def __init__(self, cell: Cell, device: str = "cuda", trace: bool = False):
        self.cell = cell
        if cell.entry["chips"] != 1:
            raise ValueError(f"cell {cell.name!r} asks for {cell.entry['chips']} chips; the harness drives one")
        engine = cell.config.get("env", {}).get("BPT_ENGINE", "torch")
        if engine != "torch":
            raise ValueError(f"configuration {cell.config['name']!r}: BPT_ENGINE={engine!r}; the harness drives "
                             "TorchEngine on one device only")
        for k in [k for k in os.environ if k.startswith("BPT_")]:
            del os.environ[k]
        os.environ.update(cell.config.get("env", {}))
        os.environ["BPT_SRS_CACHE"] = cell.path(".cache", "srs")
        import torch

        from baby_plonk_tpu_torch import config
        from baby_plonk_tpu_torch.protocol import Program, Prover, Setup
        from baby_plonk_tpu_torch.ops import ntt
        from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
        from baby_plonk_tpu_torch.utils.metrics import get_metrics

        config.set_config(config.Config())  # the switches as the environment now states them
        self.torch = torch
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)
        self.metrics = get_metrics()
        self.tracer = tracing.Tracer(self.cuda) if trace else None
        if self.tracer:
            self.tracer.install()
        self.parts: dict = {}
        cfg = cell.config
        self.n, self.gates = cfg["group_order"], cfg["circuit"]["gates"]
        self.tau = int(cfg["srs"]["tau"], 0)
        if self.cuda:
            from baby_plonk_tpu_torch.ops import kernels

            self.timed("library_s", kernels.library)
        setup = self.timed("srs_s", lambda: Setup.generate_srs_device(cfg["srs"]["powers"], self.tau, cache=True,
                                                                      device=self.dev))
        self.circuit = cell.circuit()
        self.lines = self.timed("lines_s", lambda: self.circuit.lines(self.gates))

        def keygen():
            program = Program.from_strs(self.lines, self.n)
            program.common_preprocessed_input()
            return program

        program = self.timed("keygen_s", keygen)
        self.prover = Prover(setup, program, TorchEngine(self.dev))
        self._ntt = ntt
        self._planned = False

    def timed(self, key: str, fn):
        self.sync()
        t = clock()
        out = fn()
        self.sync()
        self.parts[key] = clock() - t
        return out

    def range(self, name: str):
        return self.tracer.range(name) if self.tracer else contextlib.nullcontext()

    def traffic(self, seed: int):
        return self.timed("pool_s", lambda: self.cell.generator().Traffic(self.cell.mix, seed, self.circuit, self.gates))

    def serve_fn(self, traffic, fault: str | None = None):
        """The timed path: one request -> its proof's bytes. ``fault``
        plants one of ``FAULTS`` under it (never in a benchmark run)."""
        prover, pool = self.prover, traffic.pool

        def serve(req):
            with self.range(tracing.PROVE):
                proof = prover.prove(pool[req.witness][0], blinding=req.blinding)
            with self.range(tracing.TO_BYTES):
                return proof.to_bytes()

        if fault is None:
            return serve
        if fault == "unblinded":  # the proof made without its blinding
            return lambda req: serve(dataclasses.replace(req, blinding=[0] * 11))
        if fault == "unsplit":  # t split without its blinding scalars b10, b11
            return lambda req: serve(dataclasses.replace(req, blinding=req.blinding[:9] + [0, 0]))
        if fault == "stale":  # the first proof returned again for every request
            first = []

            def stale(req):
                if not first:
                    first.append(serve(req))
                return first[0]
            return stale
        if fault == "altered":  # one bit of the proof flipped where it is made
            def altered(req):
                out = bytearray(serve(req))
                bit = (req.index * 2654435761) % (8 * len(out))
                out[bit // 8] ^= 1 << (bit % 8)
                return bytes(out)
            return altered
        raise ValueError(f"fault {fault!r}: expected one of {FAULTS}")

    def warm(self, traffic, serve) -> None:
        """The plans (timed apart), then a cold prove of a request outside the window."""
        if not self._planned:
            self.parts["plan_s"] = plan_seconds(self._ntt, self.n, self.dev, self.sync)
            self._planned = True
        self.timed("cold_prove_s", lambda: serve(traffic.warmup()))
        if self.tracer:
            self.tracer.warm_up()

    def window(self, traffic, serve, seconds: float, run: Run) -> list:
        """The measured window; fills ``run``'s window readings."""
        self.metrics.reset()
        if self.tracer:
            self.tracer.start()
        with self.range(tracing.WINDOW):
            t0, records = traffic.drive(serve, seconds)
        self.sync()
        if self.tracer:
            run.trace = self.tracer.stop()
        run.window_s = records[-1].end - t0
        run.attempted = len(records)
        run.failed = sum(r.error is not None for r in records)
        run.proofs = run.attempted - run.failed
        run.latencies = [r.end - r.start for r in records if r.error is None]
        run.spans = dict(self.metrics.durations)
        if self.cuda:
            run.peak_mem_bytes = self.torch.cuda.max_memory_allocated(self.dev)
            run.sms = self.torch.cuda.get_device_properties(self.dev).multi_processor_count
        for r in [r for r in records if r.error][:3]:
            log(f"request {r.request.index} failed: {r.error}")
        return records

    def judge(self, traffic, records) -> dict:
        """The reference's verdict on the sampled proofs: each number compared
        with its limit."""
        t = clock()
        sample = traffic.sample(records)
        splits = sum(split for _, split in sample)
        prep = Prepared.cached(self.lines, self.n, self.tau, self.cell.path(".cache", "reference"), coset=splits > 0)
        t_prep = clock() - t
        counts = dict.fromkeys(KINDS, 0)
        for r, split in sample:
            witness, public = traffic.pool[r.request.witness]
            bad = check(prep, r.proof, witness, r.request.blinding, public, split=split)
            if bad:
                log(f"request {r.request.index}: the reference finds {bad} wrong")
            for kind, names in KINDS.items():
                counts[kind] += sum(b in names for b in bad)
        log(f"reference: circuit prepared in {t_prep:.2f} s, {len(sample)} proofs judged ({splits} with t's split) "
            f"in {clock() - t - t_prep:.2f} s")
        checks = {"failed_requests": {"value": sum(r.error is not None for r in records), "limit": 0}}
        checks.update({k: {"value": v, "limit": 0} for k, v in counts.items()})
        checks["proofs_judged"] = {"value": len(sample), "min": 1}
        if traffic.mix.get("split_sample", 0):
            checks["proofs_split_judged"] = {"value": splits, "min": 1}
        return checks


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] if "limit" in c else c["value"] >= c["min"] for c in checks.values())


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault: str | None = None, t_start: float | None = None, out=None) -> int:
    """One benchmark run; prints its result line last on ``out`` (stdout).
    Returns the exit code."""
    t_start = clock() if t_start is None else t_start
    cell = Cell(root, workload)
    session = Session(cell, device, trace)
    traffic = session.traffic(seed)
    serve = session.serve_fn(traffic, fault)
    session.warm(traffic, serve)
    run = Run(setup_parts=session.parts)
    run.setup_s = clock() - t_start
    log("set-up, s: " + " ".join(f"{k}={v:.3f}" for k, v in session.parts.items()) + f" total={run.setup_s:.3f}")
    records = session.window(traffic, serve, seconds, run)
    lat = sorted(run.latencies)
    log(f"window: {run.proofs} proofs of {run.attempted} in {run.window_s:.3f} s; latency first "
        f"{run.latencies[0] if lat else 0:.4f}, min {lat[0] if lat else 0:.4f}, median "
        f"{lat[len(lat) // 2] if lat else 0:.4f}, max {lat[-1] if lat else 0:.4f} s")
    bad = forbidden_modules()
    if bad:
        log(f"plonkbench: these modules were loaded: {bad}; the run may not import them")
        return 3
    torch, dev = session.torch, session.dev
    kind = torch.cuda.get_device_name(dev) if session.cuda else "cpu"
    del session.prover
    if session.cuda:
        torch.cuda.empty_cache()
    checks = session.judge(traffic, records)
    metrics = {}
    for m, reader in cell.readers(trace):
        try:
            value = reader.read(run)
        except Exception as e:  # a metric the cell reports that cannot be read: no result
            log(f"plonkbench: metric {m['name']} cannot be read: {type(e).__name__}: {e}")
            return 4
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    line = {"correct": is_correct(checks), "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
            "device": {"platform": "gpu" if session.cuda else "cpu", "kind": kind, "count": 1,
                       "memory_peak_bytes": run.peak_mem_bytes}}
    if run.trace is not None:
        line["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = tracing.breakdown(run.trace)
    line["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} = {c['value']} ({'at most' if 'limit' in c else 'at least'} "
            f"{c.get('limit', c.get('min'))})")
    print(json.dumps(line), file=out or sys.stdout, flush=True)
    return 0
