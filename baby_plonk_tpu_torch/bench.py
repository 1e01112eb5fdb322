"""Benchmark of the port on one CUDA card (counterpart of the JAX package's
``bench.py``):

    python -m baby_plonk_tpu_torch bench

Diagnostics go to stderr. The last line on stdout is ONE JSON object with
the JAX line's keys and meanings:

  metric "msm_g1_points_per_s", value (points/s of the fixed-base MSM over
  2^msm_log2 distinct SRS points), unit, vs_baseline (that rate over the host
  Pippenger's, ``curves/msm_host.py``, on the first 2^host_log2 of them),
  roofline_pct (the least time the card could take for the MSM's Horner
  launch, ``utils/roofline.py``, over its measured time, in %),
  ntt_coeffs_per_s and ntt_log2 (one forward NTT of 2^ntt_log2 coefficients),
  prove_warm_s (median warm prove of a 2^prove_log2-gate multiply chain),
  prove_log2, verify_s, verifier_preprocess_s (the verifier's 8 commits);

and beside them: msm_log2, host_log2, prove_warm_range_s ([min, max]),
prove_cold_s (first prove, after the plans and tables below), plan_s (the
prove sizes' NTT plans: first minus second transform of each size and
direction), tables_build_s (the fixed-base tables of the prove's SRS),
srs_device_s, srs_load_s, srs_bytes (the MSM's SRS computed and written to
its cache file, read back, the file's size), round_ms (median of each
``utils.metrics`` span over the warm proves), peak_mem_bytes (the most device
memory torch held allocated from the cold prove through the last warm one,
``torch.cuda.max_memory_allocated``), device_busy_share (device time of a
warm prove under torch.profiler over the median warm prove),
build_s (the CUDA library's build and load), device (the card's name and
power limit from nvidia-smi); with BPT_BENCH_BITSERIAL also
msm_variable_points_per_s and msm_variable_algorithm.

Environment:
  BPT_BENCH_MSM_LOG2    14  fixed-base MSM size (SRS of tau = 0xBE9C4)
  BPT_BENCH_NTT_LOG2    20  NTT size
  BPT_BENCH_HOST_LOG2   10  host baseline and exactness anchor size
  BPT_BENCH_PROVE_LOG2  16  prove size (SRS of tau = 0xDEADBEEF, cached);
                            20 is the reference's 2^20-gate configuration
                            (a few minutes, most of it host Python)
  BPT_BENCH_ITERS       10  runs each rate is the median of (warm proves:
                            at least 9)
  BPT_BENCH_BITSERIAL       set: also the variable-base MSM at the same size
                            through ``ops/msm.py::msm_device_arrays``, by the
                            algorithm ``BPT_MSM`` selects

Every time is the host clock around work that ends in
``torch.cuda.synchronize()``; tracing is off in every timed run. Card only:
without a CUDA device it raises. A wrong MSM anchor or a proof that does not
verify raises too, and then no line is printed.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MSM_TAU = 0xBE9C4
PROVE_TAU = 0xDEADBEEF
SPANS = ("prover.round_1", "prover.round_2", "prover.round_3", "prover.round_4", "prover.round_5",
         "prover.commit", "prover.intt")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def seconds(fn):
    """(seconds, result) of ``fn()``, from a drained card to a drained card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def median_seconds(fn, runs: int) -> float:
    """Median of ``runs`` timed calls of ``fn`` after one untimed call."""
    fn()
    return statistics.median(seconds(fn)[0] for _ in range(runs))


def _device_us(e) -> float:
    """Self device time of a ``key_averages()`` row (the attribute's name
    before and after torch 2.4)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def profile_device(fn, tries: int):
    """Runs of ``fn()`` under torch.profiler until two device times agree
    within 15%, ``tries`` at most: the tracer now and then loses the records
    of a window (nothing, or half the kernels of a prove). Returns (readings, agreed):
    each reading (device ms, rows, wall ms, spans) with rows (name, count,
    ms) of the kernels and copies, largest first, and the ``utils.metrics``
    report of the run; ``agreed``: the last reading agrees with an earlier
    one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .utils.metrics import get_metrics

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # starts the tracer
        torch.zeros(1, device="cuda").sum().item()
    readings = []
    while len(readings) < tries:
        get_metrics().reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        # kernel and copy rows only: a CPU operator's row repeats its kernels' time
        rows = [(e.key, e.count, _device_us(e) / 1e3) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
        total = sum(r[2] for r in rows)
        agreed = total > 0 and any(abs(total - other[0]) <= 0.15 * max(total, other[0]) for other in readings)
        readings.append((total, rows, wall_ms, get_metrics().report()))
        if agreed:
            break
    return readings, agreed


def random_scalars(rng, n: int, device) -> torch.Tensor:
    """n canonical Fr residues as raw 16-bit limbs (16, n): the top limb
    below r's."""
    from .ops import limbs

    a = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    a[-1] %= limbs.FR.modulus >> 240
    return limbs.to_device(torch.from_numpy(a.astype(np.int32)), device)


def metric_line(*, device: str, build_s: float, msm_log2: int, msm_s: float, msm_bound_s: float,
                host_log2: int, host_s: float, ntt_log2: int, ntt_s: float, srs_device_s: float,
                srs_load_s: float, srs_bytes: int, prove_log2: int, plan_s: float, tables_build_s: float,
                prove_cold_s: float, prove_warm_s: list, round_ms: dict, peak_mem_bytes: int,
                verifier_preprocess_s: float, verify_s: float, device_ms: float,
                variable: tuple | None = None) -> dict:
    """The bench's line from its timings (seconds unless named otherwise):
    ``prove_warm_s`` the warm proves, ``device_ms`` the profiled warm
    prove's device time, ``variable`` (algorithm, seconds) of the
    variable-base MSM or None."""
    msm_rate = (1 << msm_log2) / msm_s
    warm = statistics.median(prove_warm_s)
    line = {
        "metric": "msm_g1_points_per_s",
        "value": msm_rate,
        "unit": "points/s",
        "vs_baseline": msm_rate / ((1 << host_log2) / host_s),
        "roofline_pct": 100.0 * msm_bound_s / msm_s,
        "ntt_coeffs_per_s": (1 << ntt_log2) / ntt_s,
        "ntt_log2": ntt_log2,
        "prove_warm_s": warm,
        "prove_log2": prove_log2,
        "verify_s": verify_s,
        "verifier_preprocess_s": verifier_preprocess_s,
        "msm_log2": msm_log2,
        "host_log2": host_log2,
        "prove_warm_range_s": [min(prove_warm_s), max(prove_warm_s)],
        "prove_cold_s": prove_cold_s,
        "plan_s": plan_s,
        "tables_build_s": tables_build_s,
        "srs_device_s": srs_device_s,
        "srs_load_s": srs_load_s,
        "srs_bytes": srs_bytes,
        "round_ms": round_ms,
        "peak_mem_bytes": peak_mem_bytes,
        "device_busy_share": device_ms / 1e3 / warm,
        "build_s": build_s,
        "device": device,
    }
    if variable is not None:
        algorithm, var_s = variable
        line["msm_variable_points_per_s"] = (1 << msm_log2) / var_s
        line["msm_variable_algorithm"] = algorithm
    return line


def msm_section(dev, rng, msm_log2: int, host_log2: int, iters: int, bitserial: bool) -> dict:
    """The MSM's SRS (computed into its cache file, then read back), its
    fixed-base tables, the fixed-base MSM, the host baseline, the exactness
    anchor, and with ``bitserial`` the variable-base MSM."""
    from .config import get_config
    from .curves import msm_host
    from .ops import g1_vec, limbs, msm, msm_fixed
    from .protocol.setup import Setup, device_srs_path
    from .utils import roofline

    msm_n, host_n = 1 << msm_log2, 1 << min(host_log2, msm_log2)
    out = {"host_log2": min(host_log2, msm_log2)}
    # the first call always computes and writes: this SRS's own cache file
    # goes first (its content is fixed by msm_n and the tau)
    path = device_srs_path(msm_n, MSM_TAU)
    if os.path.exists(path):
        os.remove(path)
    out["srs_device_s"], made = seconds(lambda: Setup.generate_srs_device(msm_n, MSM_TAU, cache=True, device=dev))
    out["srs_load_s"], loaded = seconds(lambda: Setup.generate_srs_device(msm_n, MSM_TAU, cache=True, device=dev))
    out["srs_bytes"] = os.path.getsize(path)
    pts = made.device_points[str(dev)]
    if not all(torch.equal(a, b) for a, b in zip(pts, loaded.device_points[str(dev)])):
        raise RuntimeError("bench: the SRS read back from its cache differs from the one computed")
    log(f"SRS 2^{msm_log2} (tau {MSM_TAU:#x}): computed and written {out['srs_device_s']:.4f} s, "
        f"read back {out['srs_load_s']:.4f} s, {out['srs_bytes']} bytes in {path}")

    tabs = msm_fixed.FixedBaseTables(pts)
    msm_tables_s, _ = seconds(tabs.tables)
    log(f"fixed-base tables of 2^{msm_log2} points: {msm_tables_s:.4f} s")
    sc = random_scalars(rng, msm_n, dev)
    out["msm_s"] = median_seconds(lambda: tabs.msm(sc), iters)
    full, rest = tabs.launch_groups(msm_n)
    G = full * (tabs.chunk // msm_fixed.GROUP) + rest
    windows = msm_fixed.windows_for(G, dev)
    lane_groups = msm_fixed.groups_per_lane(1, G, dev)
    padded = torch.zeros((16, 1, msm_fixed.GROUP * G), dtype=torch.int32, device=dev)
    padded[:, 0, :msm_n] = sc
    bound_ms, bound_by = roofline.bound(*roofline.horner_work(padded, G, windows, lane_groups,
                                                              tabs.chunk // msm_fixed.GROUP))
    out["msm_bound_s"] = bound_ms / 1e3
    log(f"fixed-base MSM 2^{msm_log2}: median {out['msm_s'] * 1e3:.4f} ms of {iters} "
        f"({msm_n / out['msm_s']:.4e} points/s); Horner launch of {G} groups, W = {windows}, "
        f"K = {lane_groups}: bound "
        f"{bound_ms:.4f} ms ({bound_by}; H100 SXM peaks at 700 W)")

    host_pts = g1_vec.points_from_device(tuple(c[:, :host_n] for c in pts))
    host_sc = limbs.FR.unpack_raw(sc[:, :host_n])
    t = time.perf_counter()
    want = msm_host.msm(host_pts, host_sc)
    out["host_s"] = time.perf_counter() - t
    log(f"host Pippenger 2^{out['host_log2']}: {out['host_s'] * 1e3:.1f} ms ({host_n / out['host_s']:.4e} points/s)")
    # exactness anchor: the same launch shape, scalars past host_n zeroed
    zeroed = sc.clone()
    zeroed[:, host_n:] = 0
    if g1_vec.point_from_device(tabs.msm(zeroed)) != want:
        raise RuntimeError("bench: the fixed-base MSM differs from the host MSM")
    log("fixed-base MSM with scalars past the host size zeroed == host MSM")

    if bitserial:
        algorithm = get_config().msm_algorithm
        var_s = median_seconds(lambda: msm.msm_device_arrays(pts, sc), iters)
        if g1_vec.point_from_device(msm.msm_device_arrays(pts, sc)) != g1_vec.point_from_device(tabs.msm(sc)):
            raise RuntimeError(f"bench: the {algorithm} MSM differs from the fixed-base MSM")
        out["variable"] = (algorithm, var_s)
        log(f"variable-base MSM ({algorithm}) 2^{msm_log2}: median {var_s * 1e3:.4f} ms "
            f"({msm_n / var_s:.4e} points/s), equal to the fixed-base MSM")
    return out


def ntt_section(dev, rng, ntt_log2: int, iters: int) -> float:
    """Median seconds of one forward NTT of 2^ntt_log2 coefficients; the
    first call, which builds the plan, is timed apart."""
    from .ops import ntt

    x = random_scalars(rng, 1 << ntt_log2, dev)
    first, _ = seconds(lambda: ntt.ntt_device(x))
    ntt_s = median_seconds(lambda: ntt.ntt_device(x), iters)
    log(f"NTT 2^{ntt_log2}: first call (builds the plan) {first:.4f} s; median {ntt_s * 1e3:.4f} ms of {iters} "
        f"({(1 << ntt_log2) / ntt_s:.4e} coefficients/s)")
    return ntt_s


def prove_section(dev, prove_log2: int, iters: int) -> dict:
    """SRS, NTT plans, tables, a cold and warm proves of a multiply chain,
    the verifier, then a warm prove under torch.profiler."""
    from . import circuits
    from .ops import msm_fixed, ntt
    from .ops.torch_engine import TorchEngine
    from .protocol import Program, Prover, Setup, Verifier
    from .utils.metrics import get_metrics

    n = 1 << prove_log2
    out = {}
    constraints, witness, public = circuits.mul_chain(n)
    program = Program.from_strs(constraints, n)
    srs_s, setup = seconds(lambda: Setup.generate_srs_device(n + 6, PROVE_TAU, cache=True, device=dev))
    log(f"prove SRS 2^{prove_log2} + 6 (cached after its first run): {srs_s:.4f} s")
    # a transform's first call builds its plan and keeps it: the sizes of the
    # prove (n and 4 n), both directions, timed before the cold prove
    out["plan_s"] = 0.0
    for log2n in (prove_log2, prove_log2 + 2):
        x = torch.zeros((16, 1, 1 << log2n), dtype=torch.int32, device=dev)
        for inverse in (False, True):
            first, _ = seconds(lambda: ntt.ntt_device(x, inverse))
            second, _ = seconds(lambda: ntt.ntt_device(x, inverse))
            out["plan_s"] += first - second
    out["tables_build_s"], _ = seconds(lambda: msm_fixed.tables_for_setup(setup, dev).tables())
    log(f"NTT plans {out['plan_s']:.4f} s; fixed-base tables of 2^{prove_log2} + 6 points "
        f"{out['tables_build_s']:.4f} s")

    engine = TorchEngine(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out["prove_cold_s"], _ = seconds(lambda: Prover(setup, program, engine).prove(witness))
    warm, spans = [], {k: [] for k in SPANS}
    for _ in range(max(9, iters)):
        get_metrics().reset()
        s, proof = seconds(lambda: Prover(setup, program, engine).prove(witness))
        warm.append(s)
        for k in SPANS:
            spans[k].append(get_metrics().durations.get(k, 0.0) * 1e3)
    out["prove_warm_s"] = warm
    out["round_ms"] = {k: statistics.median(v) for k, v in spans.items()}
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    log(f"prove 2^{prove_log2}: cold {out['prove_cold_s']:.4f} s; warm median {statistics.median(warm):.4f} s of "
        f"{len(warm)} ({min(warm):.4f}-{max(warm):.4f}); span medians, ms: "
        + " ".join(f"{k}={v:.1f}" for k, v in out["round_ms"].items())
        + f"; peak device memory {out['peak_mem_bytes']} bytes")

    out["verifier_preprocess_s"], verifier = seconds(lambda: Verifier(setup, program, proof, engine=engine))
    out["verify_s"], ok = seconds(lambda: verifier.verify(public))
    if not ok:
        raise RuntimeError("bench: the proof does not verify")
    if Verifier(setup, program, proof, engine=engine).verify([(public[0] + 1) % (1 << 255)]):
        raise RuntimeError("bench: a wrong public input was accepted")
    log(f"verifier preprocessing {out['verifier_preprocess_s']:.4f} s, verify {out['verify_s']:.4f} s: "
        "accepted; a wrong public input: rejected")

    readings, agreed = profile_device(lambda: Prover(setup, program, engine).prove(witness), tries=6)
    if not agreed:
        raise RuntimeError(f"bench: no two profiled device times agree: {[r[0] for r in readings]}")
    out["device_ms"] = max(r[0] for r in readings)
    log(f"profiled warm prove: device {out['device_ms']:.3f} ms (readings "
        f"{', '.join(f'{r[0]:.3f}' for r in readings)})")
    return out


def run(env=os.environ) -> dict:
    """Every section in order, on the card; returns the line."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (torch.cuda.is_available() is false)")
    from .ops import kernels

    dev = torch.device("cuda", 0)
    device = card_line()
    log(f"card: {device}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    msm_log2 = int(env.get("BPT_BENCH_MSM_LOG2", 14))
    ntt_log2 = int(env.get("BPT_BENCH_NTT_LOG2", 20))
    host_log2 = int(env.get("BPT_BENCH_HOST_LOG2", 10))
    prove_log2 = int(env.get("BPT_BENCH_PROVE_LOG2", 16))
    iters = int(env.get("BPT_BENCH_ITERS", 10))
    if prove_log2 < 2:
        raise ValueError(f"BPT_BENCH_PROVE_LOG2 = {prove_log2}: the multiply chain needs at least 2^2 gates")
    rng = np.random.default_rng(42)

    build_s, _ = seconds(kernels.library)
    log(f"CUDA library built and loaded: {build_s:.3f} s")
    ntt_s = ntt_section(dev, rng, ntt_log2, iters)
    m = msm_section(dev, rng, msm_log2, host_log2, iters, bool(env.get("BPT_BENCH_BITSERIAL")))
    p = prove_section(dev, prove_log2, iters)
    return metric_line(
        device=device, build_s=build_s, msm_log2=msm_log2, msm_s=m["msm_s"], msm_bound_s=m["msm_bound_s"],
        host_log2=m["host_log2"], host_s=m["host_s"], ntt_log2=ntt_log2, ntt_s=ntt_s,
        srs_device_s=m["srs_device_s"], srs_load_s=m["srs_load_s"], srs_bytes=m["srs_bytes"],
        prove_log2=prove_log2, plan_s=p["plan_s"], tables_build_s=p["tables_build_s"],
        prove_cold_s=p["prove_cold_s"], prove_warm_s=p["prove_warm_s"], round_ms=p["round_ms"],
        peak_mem_bytes=p["peak_mem_bytes"],
        verifier_preprocess_s=p["verifier_preprocess_s"], verify_s=p["verify_s"], device_ms=p["device_ms"],
        variable=m.get("variable"))


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0
