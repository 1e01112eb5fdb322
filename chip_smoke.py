#!/usr/bin/env python3
"""Smoke run of baby_plonk_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and kernel checks)
    python3 chip_smoke.py --msm-times  # phases 1-2, then only the commit MSMs and trees timed at
                                     # the prove's shapes through entry points that every
                                     # version of the package has (copy the script beside an
                                     # older package to time that one on the same card)
    python3 chip_smoke.py --setup-times  # phases 1-2, then only the two set-up kernels (powers of
                                     # tau, the fixed-base tables) timed at the main path's shapes,
                                     # the same way
    python3 chip_smoke.py --prove-profile  # phases 1-2, then one warm 2^16 prove profiled, its
                                     # addition and tree launches and copy kernels, the same way
    python3 chip_smoke.py --plan-times  # phases 1-2, then the first transforms' plan time split
                                     # into its pieces at 2^16 and 2^20 gates (a fresh process)
    python3 chip_smoke.py --large    # phases 1-2, then phase 11 alone

The plans, cold and warm proves with their round spans, timed in a process
that runs nothing else: ``python -m baby_plonk_tpu_torch bench``.

Phases, each printed with its seconds:
  1. device: name and power limit (nvidia-smi); no CUDA device -> exit 1
  2. build: nvcc of the package's CUDA sources into one library
  3. kernels: every kernel of the paths below against its plain PyTorch
     version on the card, at the paths' shapes, exact equality (integers: no
     tolerance), timed beside the plain version, with the least time the
     card could take for the same work (bound). A row's time is DEVICE time:
     the kernels and copies its call puts on the card, summed by
     torch.profiler over the timed calls (events around back-to-back calls
     measure the Python wrapper wherever that takes longer than the kernel);
     beside it the wrapper's host time a call (host_us, host clock around the
     same loop, no synchronise inside). The Fr and Fq product, square and
     power on edge operands; the fixed-base, bit-serial and Pippenger MSMs
     also against the exact host MSM. The Pippenger MSM (one
     bpt_msm_pippenger call) against its plain version at the prove's 65,538
     points (c = 14), at 2^14 points and on skewed scalars (all equal; a run
     of 1000 equal scalars across many chunks), with its latency floor (the
     Horner chain: c (nwin - 1) one-lane doublings and nwin - 1 additions)
     beside the bound. The two point-MSM kernels are exact at
     one 2^14-point chunk and at a small ragged shape (their plain versions
     take seconds a chunk) and timed at the shapes the proves give them;
     round 3's combination also in the mesh's form, z(w x) from a row of
     its own, at the shapes of a shard of phase 9's D = 4 and D = 8 proves.
     The group tree at the fixed-base commit's shapes, the Horner partials'
     (24, 3, W, 4, 2048) view and the chunk combine (24, 3, W, 8), one launch
     each, with its depth floor beside the bound: log2(n) times the device
     time of one addition on one lane of shape (24,) (the g1_padd row).
     The set-up kernels at the main path's widths: powers of tau over 2^16 +
     6 lanes (and 2^10, and the scalars 0, 1, 2, r - 1) with the plain
     version's own table of multiples, the table (255 doublings, then the
     table build) timed kernel by kernel; the table build over the prove's SRS, 8193 groups,
     and one 2^14-point chunk
  4. main path: device SRS at 2^16 + 6 powers (the generator's table of
     multiples dropped first, so the SRS builds it), a 2^16-gate multiply chain,
     a cold and a warm prove, verify, a wrong public input rejected; every
     kernel of the path must have launched, the sub-NTT kernel exactly twice
     a transform, the field product fewer than 220 times a warm prove, the
     group tree 3 times a commit and the elementwise addition never; then
     warm proves under torch.profiler (until two readings agree):
     device time by kernel name and the busy share, no index_select kernel
  5. cross-engine: at 2^8 gates with fixed blinding the proof bytes equal
     the host engine's
  6. variable-base path: the same 2^16 circuit and SRS with
     commit_fixed_base=False, a prove + verify with msm_algorithm
     "bitserial" and one with "pippenger", fixed blinding; proof bytes equal
     to each other and to the fixed-base proof of the same blinding; the
     bit-serial prove launches msm_partials once a commit (9), the Pippenger
     prove bpt_msm_pippenger once a commit (9) and g1_padd, g1_pdouble and
     msm_partials never; neither launches the Horner kernel
  7. setup cache: on a fresh temporary cache directory,
     Setup.generate_srs_device(2^16 + 6, cache=True) twice (writes, then
     reads); the points read back equal phase 4's, and a prove from them
     gives phase 6's fixed-base proof bytes
  8. bench: python -m baby_plonk_tpu_torch bench in a child process at small
     sizes (MSM, prove 2^12, NTT 2^16, host 2^8, with the bit-serial MSM) on
     the same cache directory; its last line parses with every key
  9. mesh: the prover sharded over D = 4 shards on min(4, cards) cards
     (parallel/): the sharded powers of tau equal phase 4's SRS; the
     distributed NTT at 2^16 and 2^18 (forward, inverse, dual) equals
     ntt_device reordered by cyclic_perm; both sharded MSMs over 65,538
     points and the sharded round-1 step at 2^16 equal the single-device
     commits; MeshEngine proves the 2^16 circuit (cold and warm fixed-base,
     once bit-serial) to phase 6's fixed-base bytes and verifies, rejects a
     wrong public input; a D = 8 prove at 2^12 gives TorchEngine's bytes; the
     Horner, msm_partials and sub-NTT kernels launched and no wrapper saw a
     CPU tensor
 10. multi-process mesh: the prover over a ProcessMesh of two processes
     (parallel/multihost_smoke.py spawns them; gloo on one card, both
     processes on cuda:0, the bytes in flight staged through host memory;
     nccl too, one process a card, on two cards or more): each worker runs
     the sharded round-1 step against the host oracle, then MeshEngine at
     D = 4 on the 2^16 circuit from the SRS that the parent wrote to a fresh
     cache directory (fixed-base cold and warm, once bit-serial), each to
     phase 6's fixed-base bytes, verifies, rejects a wrong public input; and
     at D = 8 on 2^12 (z(w x) rows from the other process) to TorchEngine's
     bytes. Each run must launch the sub-NTT (twice a transform), the mesh's
     round3_combine, grand_product_fg, field_scan and its commit kernel, and
     no wrapper may see a CPU tensor; printed per worker and backend: each
     prove's seconds, and its cross-process collectives and bytes sent
 11. 2^20 gates, the reference's configuration (BASELINE.md): the device SRS
     of 2^20 + 6 powers, mul_chain(2^20), Program.from_strs, the proving
     key and the fixed-base tables (131,073 groups), each timed; the first
     transform of 2^20 and 2^22 in each direction (its plan); a cold and a
     warm prove with their spans and the device memory after each round; the
     624-byte proof verifies, a wrong public input is rejected; at the
     default widths rounds 4 and 5 run in position chunks and round 3's
     caches hold; under the same blinding the Pippenger and the bit-serial
     prove (9 launches of their MSM, no g1_padd) and a prove with the memory
     governors forced (chunks of 2^17, both round-3 budgets 0, nothing
     cached) give the same bytes; then the kernels at the path's shapes
     against their plain versions: the (16, 1, 2^22) NTT forward and inverse
     through the composed passes (4 sub-NTT launches, 1 composed call),
     round 3's combination at 2^22 lanes, the Horner kernel over 3 x 131,073
     groups and the group tree over its 64 chunks, the table build over
     131,073 groups and powers of tau over 2^20 + 6 lanes (the plain versions
     on the whole, or on slices at both ends where the whole would take
     minutes)
Then one JSON line of kernels (each row with its launches on the main or
the named path, on the same path through MeshEngine, through it over two
processes (launches_mp), and on phase 11's 2^20 path (launches_2p20)), the
card line with the cold and warm prove of phases 4, 9, 10 and 11, and the
final status line.
Any failure raises: non-zero exit, no status line.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260101
TAU = 0x5EED_7A0

def popcount(scalars) -> int:
    """Set bits of a raw 16-bit limb tensor."""
    import torch

    bits = torch.arange(16, device=scalars.device)
    return int(((scalars.reshape(-1, 1) >> bits) & 1).sum())


def phase(name, t0, extra=""):
    print(f"[{name}] {time.perf_counter() - t0:.3f} s {extra}".rstrip(), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warm=True):
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Device time of one call of ``fn``: every kernel and copy that ``reps``
    back-to-back calls put on the card, summed by torch.profiler, over reps.
    Unlike events around the loop it does not count the gaps the host leaves.
    A reading counts once a second one agrees with it within 15%
    (``bench.profile_device``): the larger of the agreeing ones is returned."""
    from baby_plonk_tpu_torch.bench import profile_device

    fn()
    readings, agreed = profile_device(lambda: [fn() for _ in range(reps)], tries=6)
    if not agreed:
        raise AssertionError(f"torch.profiler gave no two device times that agree: {[r[0] for r in readings]}")
    last = readings[-1][0]
    return max(r[0] for r in readings if abs(r[0] - last) <= 0.15 * max(r[0], last)) / reps


def host_us(fn, reps):
    """Host time of one call of the wrapper: the host clock around ``reps``
    calls with no synchronise inside (the card drains while the host queues)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def timed(fn, reps):
    """(device ms, host us) of one call of ``fn``."""
    return device_ms(fn, reps), host_us(fn, reps)


def timed_events(fn, reps):
    """The same with the device time from CUDA events around the calls: for
    a kernel of a millisecond or more the card, not the wrapper, is the limit."""
    return cuda_ms(fn, reps), host_us(fn, reps)


def once_ms(fn):
    """(fn(), ms) of one call ending in a synchronise: a plain version is
    timed on the call whose result is compared."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def kernel_ms(fn, names):
    """Device ms of each kernel of one call of ``fn`` whose name holds one
    of ``names`` (torch.profiler, two agreeing readings)."""
    from baby_plonk_tpu_torch.bench import profile_device

    fn()
    readings, agreed = profile_device(fn, tries=6)
    if not agreed:
        raise AssertionError("torch.profiler gave no two device times that agree")
    rows = readings[-1][1]
    return {n: sum(ms for key, _, ms in rows if n in key) for n in names}


def max_abs_err(got, want):
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape, (tuple(g.shape), tuple(w.shape))
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def random_field(rng, spec, shape, device):
    """Canonical residues (L, *shape) as 16-bit limbs, top limb below p's."""
    import numpy as np
    import torch

    a = rng.integers(0, 1 << 16, size=(spec.L,) + tuple(shape), dtype=np.int64)
    a[-1] %= spec.modulus >> (16 * (spec.L - 1))
    return torch.from_numpy(a.astype(np.int32)).to(device)


def record_row(results, name, source, replaces, wrapper, err, times, plain_ms, nbytes, mads, run=None, **extra):
    """Append one kernel row to ``results``. ``times``: (device ms, host us)
    of one call of the wrapper; ``nbytes``: every input read once and every
    output written once; ``mads``: the 32-bit multiply-adds this run's inputs
    need. No single PyTorch call computes any of these modular functions:
    library_ms is null throughout. ``run``: the prove of phase 6 that gives
    the wrapper this shape ("bitserial" or "pippenger"), None for the main
    path, "mesh" for a form only phase 9's MeshEngine prove calls, "2^20" for
    phase 11's 2^20-gate path, "off" for a wrapper that no prove calls any
    more. ``extra``: further keys of the row."""
    from baby_plonk_tpu_torch.utils.roofline import bound

    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
    ms, wrapper_us = times
    bound_ms, bound_by = bound(nbytes, mads)
    results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "wrapper": wrapper, "run": run, "max_abs_err": err, "ms": ms, "host_us": wrapper_us,
                    "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": None, **extra})
    print(f"  {name}: exact, device {ms:.4f} ms, host {wrapper_us:.1f} us a call, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4g} ms ({bound_by}), share {bound_ms / ms:.2f}", flush=True)


def check_kernels(dev, results):
    """Phase 3: each kernel wrapper on the card against its plain version."""
    import numpy as np
    import torch

    from baby_plonk_tpu_torch.curves import msm_host
    from baby_plonk_tpu_torch.ops import (g1_vec, kernels, limbs, msm, msm_fixed, msm_pippenger, ntt,
                                          prover_kernels, srs)
    # the peaks and work counts behind every bound (shared with the bench)
    from baby_plonk_tpu_torch.utils.roofline import (ADD_MULS, DOUBLE_MADS, FQ_BYTES, FQ_MUL, FQ_SQR, FR_BYTES,
                                                     FR_MUL, FR_SQR, bound, horner_work, pippenger_work,
                                                     powers_of_tau_work, tables_work, tree_work)

    rng = np.random.default_rng(SEED)
    FR, FQ = limbs.FR, limbs.FQ

    def record(*args, **kwargs):
        record_row(results, *args, **kwargs)

    FIELD_CU = "baby_plonk_tpu_torch/csrc/field.cu"
    PALLAS = "baby_plonk_tpu/ops/pallas_kernels.py"

    # the host cost of the one test ``kernels.launch`` adds to every launch
    reps = 100000
    t0 = time.perf_counter()
    for _ in range(reps):
        dev.index == torch.cuda.current_device()
    print(f"  launch guard (device.index == torch.cuda.current_device()): "
          f"{(time.perf_counter() - t0) / reps * 1e6:.4f} us a launch", flush=True)

    # -- field elementwise (2^16 lanes) --------------------------------------
    n = 1 << 16
    # The bytes bound is over the HBM rate, and two 4 MB operands called again
    # and again stay in the 50 MB L2. So the timed calls of these rows go round
    # ROTATE sets of operands and keep as many results alive (12 MB a set,
    # 192 MB in all): every call reads and writes lines that have left the L2.
    ROTATE = 16
    sets = [(random_field(rng, FR, (n,), dev), random_field(rng, FR, (n,), dev)) for _ in range(ROTATE)]

    def rotating(op):
        """A call that applies ``op(a, b)`` to the next set of operands."""
        kept, turn = [None] * ROTATE, [0]

        def call():
            i = turn[0] = (turn[0] + 1) % ROTATE
            kept[i] = op(*sets[i])
        return call

    for spec, tag in ((FR, "fr"), (FQ, "fq")):
        a, b = random_field(rng, spec, (n,), dev), random_field(rng, spec, (n,), dev)
        got = limbs.mont_mul(spec, a, b)
        want = limbs._mont_mul_plain(spec, a, b)
        if tag == "fr":
            record("mont_mul", FIELD_CU, f"{PALLAS}:43", "limbs.mont_mul",
                   max_abs_err(got, want), timed(rotating(lambda a, b: limbs.mont_mul(FR, a, b)), 64),
                   cuda_ms(lambda: limbs._mont_mul_plain(spec, a, b), 5),
                   3 * FR_BYTES * n, FR_MUL * n)
            # the broadcast instantiation (an index map with 64-bit divisions):
            # 8 rows against one, and one scalar against all lanes
            a8, s1 = random_field(rng, FR, (8, n), dev), random_field(rng, FR, (1,), dev)
            assert max_abs_err(limbs.mont_mul(FR, a8, b), limbs._mont_mul_plain(FR, a8, b)) == 0, "broadcast rows"
            assert max_abs_err(limbs.mont_mul(FR, s1, b), limbs._mont_mul_plain(FR, s1, b)) == 0, "broadcast scalar"
            ms_b, us_b = timed(lambda: limbs.mont_mul(FR, s1, b), 50)
            print(f"  mont_mul, (16, 1) scalar against (16, 2^16): exact, device {ms_b:.4f} ms, host {us_b:.1f} us a call",
                  flush=True)
        else:
            assert max_abs_err(got, want) == 0, "Fq mont_mul differs from its plain version"
            print("  mont_mul (Fq, 2^16): exact", flush=True)
    a, b = random_field(rng, FR, (n,), dev), random_field(rng, FR, (n,), dev)
    record("add_mod", FIELD_CU, "baby_plonk_tpu/ops/limbs.py:325", "limbs.add_mod",
           max_abs_err(limbs.add_mod(FR, a, b), limbs._add_plain(FR, a, b)),
           timed(rotating(lambda a, b: limbs.add_mod(FR, a, b)), 64), cuda_ms(lambda: limbs._add_plain(FR, a, b), 5),
           3 * FR_BYTES * n, 2 * 8 * n)  # two 8-word carry chains, no products
    # the subtraction left the main path with the fused round-3 expression
    # (DPoly.__sub__ and the debug checks still reach it): a row off every path
    record("sub_mod", FIELD_CU, "baby_plonk_tpu/ops/limbs.py:334", "limbs.sub_mod",
           max_abs_err(limbs.sub_mod(FR, a, b), limbs._sub_plain(FR, a, b)),
           timed(rotating(lambda a, b: limbs.sub_mod(FR, a, b)), 64), cuda_ms(lambda: limbs._sub_plain(FR, a, b), 5),
           3 * FR_BYTES * n, 2 * 8 * n, run="off")
    r2 = limbs._c64(FR, FR.R2, dev)
    one = limbs._c64(FR, 1, dev)
    record("to_mont", FIELD_CU, "baby_plonk_tpu/ops/limbs.py:824",
           "limbs.to_mont", max_abs_err(limbs.to_mont(FR, a), limbs._mont_mul_plain(FR, a, r2)),
           timed(rotating(lambda a, b: limbs.to_mont(FR, a)), 64),
           cuda_ms(lambda: limbs._mont_mul_plain(FR, a, r2), 5), 2 * FR_BYTES * n, FR_MUL * n)
    record("from_mont", FIELD_CU, "baby_plonk_tpu/ops/limbs.py:812",
           "limbs.from_mont", max_abs_err(limbs.from_mont(FR, a), limbs._mont_mul_plain(FR, a, one)),
           timed(rotating(lambda a, b: limbs.from_mont(FR, a)), 64),
           cuda_ms(lambda: limbs._mont_mul_plain(FR, a, one), 5), 2 * FR_BYTES * n, FR_MUL * n)
    # off the main path, checked all the same
    assert max_abs_err(limbs.neg_mod(FR, a), limbs._neg_plain(FR, a)) == 0, "neg_mod"
    cond = torch.from_numpy(rng.integers(0, 2, size=n).astype(bool)).to(dev)
    assert max_abs_err(limbs.select(cond, a, b), torch.where(cond[None], a, b)) == 0, "select"
    print("  neg_mod, select (off the main path): exact", flush=True)

    # edge operands of the product and the dedicated square, both fields: a
    # dropped carry shows on these, not on random operands
    for spec in (FR, FQ):
        p, R = spec.modulus, 1 << (16 * spec.L)
        top = p >> (16 * spec.L - 32)
        ones = ((top - 1) << (16 * spec.L - 32)) | ((1 << (16 * spec.L - 32)) - 1)
        edge = [0, 1, p - 1, R % p, R * R % p, ones, (p - 1) ** 2 % p]
        ea = spec.pack_raw([x for x in edge for _ in edge], dev)
        eb = spec.pack_raw([y for _ in edge for y in edge], dev)
        assert max_abs_err(limbs.mont_mul(spec, ea, eb), limbs._mont_mul_plain(spec, ea, eb)) == 0, "product, edge operands"
        assert max_abs_err(limbs.mont_sqr(spec, ea), limbs._mont_mul_plain(spec, ea, ea)) == 0, "square, edge operands"
        rnd = random_field(rng, spec, (n,), dev)
        assert max_abs_err(limbs.mont_sqr(spec, rnd), limbs._mont_mul_plain(spec, rnd, rnd)) == 0, "square, 2^16 lanes"
    print(f"  product and square on {len(edge)}^2 edge operands, square on 2^16 lanes (Fr, Fq): exact", flush=True)

    # -- power in the kernel: one lane (the grand product's and the affine
    # conversion's inverse) and 2^10 lanes, Fr and Fq, e = p - 2 ----------------
    for spec, tag, sqr_mads, mul_mads, nb in ((FR, "Fr", FR_SQR, FR_MUL, FR_BYTES), (FQ, "Fq", FQ_SQR, FQ_MUL, FQ_BYTES)):
        e = spec.modulus - 2
        lane_mads = (e.bit_length() - 1) * sqr_mads + (bin(e).count("1") - 1) * mul_mads
        edge = spec.pack_mont([0, 1, spec.modulus - 1], dev)
        assert max_abs_err(limbs.mont_pow_fixed(spec, edge, e), limbs._mont_pow_plain(spec, edge, e)) == 0, "power, edge operands"
        assert spec.unpack_mont(limbs.mont_pow_fixed(spec, edge, e)) == [0, 1, spec.modulus - 1], "inverse of 0, 1, p - 1"
        for lanes, label in ((1, "1 lane"), (1 << 10, "2^10 lanes")):
            x = random_field(rng, spec, (lanes,), dev)
            before = limbs.mont_pow_fixed.launches
            got = limbs.mont_pow_fixed(spec, x, e)
            assert limbs.mont_pow_fixed.launches == before + 1, "mont_pow_fixed of a CUDA tensor is one launch"
            record(f"field_pow ({tag}, {label})", FIELD_CU, "baby_plonk_tpu/ops/limbs.py:842",
                   "limbs.mont_pow_fixed", max_abs_err(got, limbs._mont_pow_plain(spec, x, e)),
                   timed(lambda: limbs.mont_pow_fixed(spec, x, e), 5),
                   cuda_ms(lambda: limbs._mont_pow_plain(spec, x, e), 1, warm=False),
                   2 * nb * lanes, lane_mads * lanes)

    # -- one-pass scans: product and sum, 2^16 and 2^17 lanes, every flag -----
    for log2n in (16, 17):
        x = random_field(rng, FR, (1 << log2n,), dev)
        for op, mads in (("mul", FR_MUL), ("add", 8)):
            for reverse in (False, True):
                for exclusive in (False, True):
                    got = limbs.field_scan(FR, x, op, reverse, exclusive)
                    want = limbs.field_scan(FR, x, op, reverse, exclusive, plain=True)
                    err = max_abs_err(got, want)
                    if reverse or exclusive:
                        assert err == 0, f"field_scan {op} reverse={reverse} exclusive={exclusive} differs"
                        continue
                    record(f"field_scan ({'product' if op == 'mul' else 'sum'}, 2^{log2n})", FIELD_CU,
                           "baby_plonk_tpu/ops/limbs.py:860", "limbs.field_scan", err,
                           timed(lambda: limbs.field_scan(FR, x, op), 20),
                           cuda_ms(lambda: limbs.field_scan(FR, x, op, plain=True), 1, warm=False),
                           2 * FR_BYTES * (1 << log2n), mads * (1 << log2n))
    print("  field_scan, reversed and exclusive, product and sum, 2^16 and 2^17: exact", flush=True)
    inv_in = random_field(rng, FQ, (2048,), dev)
    assert max_abs_err(limbs.batch_inverse(FQ, inv_in), limbs.batch_inverse(FQ, inv_in, plain=True)) == 0, "batch_inverse"
    print("  batch_inverse (Fq, 2048 lanes: two scans and one power): exact", flush=True)

    # -- power table at 2^18 (round 3's coset powers) and 2^17 (evaluations) --
    z = random_field(rng, FR, (1,), dev)
    for log2n in (18, 17):
        m = 1 << log2n
        err = max_abs_err(limbs.pow_table(FR, z, m), limbs.pow_table(FR, z, m, plain=True))
        if log2n == 18:
            record("pow_table (2^18)", FIELD_CU, "baby_plonk_tpu/ops/dpoly.py:60", "limbs.pow_table", err,
                   timed(lambda: limbs.pow_table(FR, z, m), 20),
                   cuda_ms(lambda: limbs.pow_table(FR, z, m, plain=True), 1, warm=False),
                   FR_BYTES * (m + 1), FR_MUL * m)
        else:
            assert err == 0, "pow_table at 2^17 differs"

    # -- fused round expressions: round 3 at 2^18 lanes, round 2 at 2^16 -------
    m = 1 << 18
    live, fixed = random_field(rng, FR, (5, m), dev), random_field(rng, FR, (9, m), dev)
    zh_inv, dpow = random_field(rng, FR, (m,), dev), random_field(rng, FR, (m,), dev)
    sc = random_field(rng, FR, (6,), dev)
    record("round3_combine (2^18 lanes)", FIELD_CU, "baby_plonk_tpu/ops/prover_kernels.py:75",
           "prover_kernels.round3_combine",
           max_abs_err(prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4),
                       prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4, plain=True)),
           timed(lambda: prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4), 10),
           cuda_ms(lambda: prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4, plain=True), 1, warm=False),
           FR_BYTES * (17 * m + 6), 19 * FR_MUL * m)  # 16 rows in (z(wx) is the z row again), one out; 19 products a lane
    # the mesh's form: z(w x) from a row of its own (MeshEngine.round3_quotient
    # passes the z row of shard (d + 4) mod D, a strided view the wrapper
    # copies), at the shapes of a shard: D = 4 at 2^16 gates (2^16 lanes,
    # shift 1) and D = 8 at 2^12 (2^11 lanes, shift 0 on shards 0-3, 1 on 4-7)
    for lanes, shifts in ((1 << 16, (1,)), (1 << 11, (0, 1))):
        live, fixed = random_field(rng, FR, (5, lanes), dev), random_field(rng, FR, (9, lanes), dev)
        zh_inv, dpow = random_field(rng, FR, (lanes,), dev), random_field(rng, FR, (lanes,), dev)
        zw = random_field(rng, FR, (5, lanes), dev)[:, 3]
        for shift in shifts:
            def combine(plain=False):
                return prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, shift, zw=zw, plain=plain)
            err = max_abs_err(combine(), combine(plain=True))
            if lanes == 1 << 16:
                record("round3_combine, zw row (2^16 lanes, a D = 4 shard)", FIELD_CU,
                       "baby_plonk_tpu/ops/prover_kernels.py:75", "prover_kernels.round3_combine (zw)", err,
                       timed(combine, 10), cuda_ms(lambda: combine(plain=True), 1, warm=False),
                       FR_BYTES * (18 * lanes + 6), 19 * FR_MUL * lanes, run="mesh")  # 17 rows in, one out
            else:
                assert err == 0, f"round3_combine with a zw row differs at 2^11 lanes, shift {shift}"
    print("  round3_combine, zw row at 2^11 lanes (a D = 8 shard), shift 0 and 1: exact", flush=True)
    del live, fixed, zh_inv, dpow, zw
    rows = [random_field(rng, FR, (n,), dev) for _ in range(7)]
    scal = [int(v) for v in rng.integers(1, 1 << 62, size=4)]
    record("grand_product_fg (2^16)", FIELD_CU, "baby_plonk_tpu/ops/tpu_engine.py:85",
           "prover_kernels.grand_product_fg",
           max_abs_err(prover_kernels.grand_product_fg(*rows, *scal), prover_kernels.grand_product_fg(*rows, *scal, plain=True)),
           timed(lambda: prover_kernels.grand_product_fg(*rows, *scal), 20),
           cuda_ms(lambda: prover_kernels.grand_product_fg(*rows, *scal, plain=True), 1, warm=False),
           FR_BYTES * (9 * n + 4), 12 * FR_MUL * n)  # 7 rows in, 2 out; 12 products a lane

    # -- sub-NTT (16, 1, 256, 256) and the four-step at the prove's sizes ------
    NTT_CU = "baby_plonk_tpu_torch/csrc/ntt.cu"
    x = random_field(rng, FR, (1, 256, 256), dev)
    for inverse in (False, True):
        pw = ntt.sub_twiddles(256, inverse, dev)
        got, want = kernels.ntt_sub(x, inverse), kernels.ntt_sub_plain(x, pw)
        err = max_abs_err(got, want)
        if not inverse:
            record("ntt_sub", NTT_CU, f"{PALLAS}:355", "kernels.ntt_sub", err,
                   timed(lambda: kernels.ntt_sub(x, False), 20),
                   cuda_ms(lambda: kernels.ntt_sub_plain(x, pw), 2),
                   FR_BYTES * (2 * 256 * 256 + 128),  # elements in and out, the 128 twiddles
                   FR_MUL * (256 // 2) * 8 * 256,     # one product per butterfly
                   smem_bytes=kernels.sub_smem_bytes(256, kernels._columns_per_block(256, 256)))
        else:
            assert err == 0, "inverse sub-NTT differs from its plain version"
    x8 = random_field(rng, FR, (8, 1 << 16), dev)
    x18 = random_field(rng, FR, (5, 1 << 18), dev)
    for xx, label in ((x8, "(16, 8, 2^16)"), (x18, "(16, 5, 2^18)")):
        for inverse in (False, True):
            err = max_abs_err(ntt.ntt_device(xx, inverse), ntt.ntt_device(xx, inverse, plain=True))
            assert err == 0, f"ntt_device {label} inverse={inverse} differs"
        print(f"  ntt_device {label}: exact, forward and inverse (1/n in the cross twiddles)", flush=True)
    for xx, K, log2m in ((x8, 8, 16), (x18, 5, 18)):
        m = 1 << log2m
        x4 = xx.reshape(16, K, m, 1)
        m1, m2 = ntt.split(m)
        before = kernels.ntt_sub.launches
        got = kernels.ntt_sub_4step(x4, False)
        assert kernels.ntt_sub.launches == before + 2, "a four-step transform is two launches of the sub-NTT kernel"
        assert max_abs_err(kernels.ntt_sub_4step(x4, True), kernels.ntt_sub_4step(x4, True, plain=True)) == 0, (
            "unscaled inverse four-step differs")
        record(f"ntt_sub_4step (16, {K}, 2^{log2m}, 1)", f"{NTT_CU} (two launches, baby_plonk_tpu_torch/ops/kernels.py)",
               f"{PALLAS}:402", "kernels.ntt_sub_4step",
               max_abs_err(got, kernels.ntt_sub_4step(x4, False, plain=True)),
               timed(lambda: kernels.ntt_sub_4step(x4, False), 10),
               cuda_ms(lambda: kernels.ntt_sub_4step(x4, False, plain=True), 1, warm=False),
               FR_BYTES * (2 * K + 1) * m,  # K polys in and out, the cross-twiddle table
               FR_MUL * K * ((m // 2) * log2m + m),  # butterflies + cross twiddles
               columns=(kernels._columns_per_block(m1, m2), kernels._columns_per_block(m2, m1)))
    del x18, x4, sets

    # -- powers of tau: the generator's doubling chain and table of multiples,
    # then the windowed kernel at the main path's 2^16 + 6 lanes and at 2^10 --
    # (each plain version is timed on the call whose result is compared)
    SRS_CU = "baby_plonk_tpu_torch/csrc/srs.cu"
    base = srs.generator_base(dev)
    # (the plain chain on the host: 255 one-lane doublings, each a few ms
    # of small launches on the card)
    chain_p = tuple(c.to(dev) for c in srs.doubling_chain_plain(base.cpu()))
    assert max_abs_err(srs.doubling_chain(base), chain_p) == 0, "the doubling chain differs from its plain version"
    table_p = msm_fixed.build_tables_plain(*chain_p)

    def fresh_table():
        srs.base_tables.clear()
        return srs.base_table(base)
    table_ms = cuda_ms(fresh_table, 3)
    assert torch.equal(srs.base_table(base), table_p), "the generator's table differs from the plain build"
    n_srs = (1 << 16) + 6
    sc = srs.tau_scalars(n_srs, TAU, dev)
    sc10 = sc[:, : 1 << 10].contiguous()
    srs_pts = srs.powers_of_tau(sc, base)
    want, pot_plain_ms = once_ms(lambda: srs.powers_of_tau_plain(sc, base, table_p))
    err = max_abs_err(srs_pts, want)
    assert max_abs_err(srs.powers_of_tau(sc10, base), srs.powers_of_tau_plain(sc10, base, table_p)) == 0, (
        "powers_of_tau differs from its plain version at 2^10 lanes")
    edge = FR.pack_raw([0, 1, 2, FR.modulus - 1], dev)
    assert max_abs_err(srs.powers_of_tau(edge, base), srs.powers_of_tau_plain(edge, base, table_p)) == 0, (
        "powers_of_tau differs from its plain version on the scalars 0, 1, 2, r - 1")
    print(f"  powers_of_tau: the generator's table (255 doublings + build_tables over 32 groups) {table_ms:.4f} ms; "
          "exact at 2^16 + 6 and 2^10 lanes and on the scalars 0, 1, 2, r - 1", flush=True)
    record("powers_of_tau", SRS_CU, "baby_plonk_tpu/ops/srs.py:24", "srs.powers_of_tau", err,
           timed(lambda: srs.powers_of_tau(sc, base), 3), pot_plain_ms,
           *powers_of_tau_work(sc), shape="2^16 + 6 lanes, the table kept",
           ms_2_10=cuda_ms(lambda: srs.powers_of_tau(sc10, base), 5), bound_ms_2_10=bound(*powers_of_tau_work(sc10))[0],
           table_ms=table_ms, table_bound_ms=bound(FQ_BYTES * 3 * srs.CHAIN, DOUBLE_MADS * (srs.CHAIN - 1))[0]
           + bound(*tables_work(srs.WINDOWS))[0],
           table_kernel_ms=kernel_ms(fresh_table, ("g1_pdouble", "build_tables", "tables_invert", "normalize_tables")),
           plain_shape="2^16 + 6 lanes, the plain version's own table")
    del table_p, chain_p, want

    # -- the table build: the prove's SRS (8193 groups) and one 2^14-point chunk
    chunk = msm_fixed.CHUNK
    groups = chunk // msm_fixed.GROUP
    full, rest = msm_fixed.FixedBaseTables(srs_pts).launch_groups(n_srs)
    g_srs = full * groups + rest
    path_pts = tuple(torch.cat([c, c[:, :1].expand(24, 8 * g_srs - n_srs)], dim=-1) for c in srs_pts)
    want, tables_plain_ms = once_ms(lambda: msm_fixed.build_tables_plain(*path_pts))
    t_path = msm_fixed.build_tables(*path_pts)
    pts = tuple(c[:, :chunk].contiguous() for c in srs_pts)
    t_k = msm_fixed.build_tables(*pts)
    # one chunk is the SRS's first 2048 groups: its plain tables are want's first rows
    assert max_abs_err(t_k, want[:groups]) == 0, "build_tables differs from its plain version on one chunk"
    record("msm_build_tables", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/msm_fixed.py:83", "msm_fixed.build_tables", max_abs_err(t_path, want),
           timed_events(lambda: msm_fixed.build_tables(*path_pts), 3), tables_plain_ms, *tables_work(g_srs),
           shape=f"the prove's SRS, {g_srs} groups", ms_one_chunk=cuda_ms(lambda: msm_fixed.build_tables(*pts), 3),
           kernel_ms=kernel_ms(lambda: msm_fixed.build_tables(*path_pts), ("build_tables", "tables_invert", "normalize_tables")),
           bound_ms_one_chunk=bound(*tables_work(groups))[0])
    del t_path, path_pts, want
    scal = random_field(rng, FR, (1, chunk), dev)

    one_chunk = {
        "err": max_abs_err(msm_fixed.msm_fixed_horner(t_k, scal, 1), msm_fixed.msm_fixed_plain(t_k, scal, 1)),
        "ms": cuda_ms(lambda: msm_fixed.msm_fixed_horner(t_k, scal, 1), 5),
        "plain_ms": cuda_ms(lambda: msm_fixed.msm_fixed_plain(t_k, scal, 1), 1, warm=False),
        "bound_ms": bound(*horner_work(scal, groups, 1))[0],
    }
    assert one_chunk["err"] == 0, "msm_fixed_horner differs from its plain version on one chunk"
    print(f"  msm_fixed_horner, one 2^14-point chunk, 1 set, W = 1: exact, kernel {one_chunk['ms']:.4f} ms, "
          f"plain {one_chunk['plain_ms']:.1f} ms, bound {one_chunk['bound_ms']:.4g} ms", flush=True)
    # a small ragged shape: 3 sets of 2^11 + 6 scalars, the launch sized to
    # them (256 + 1 groups), each window split against the plain version
    n_small = (1 << 11) + 6
    small_tabs = msm_fixed.FixedBaseTables(tuple(c[:, :n_small].contiguous() for c in srs_pts), chunk=1 << 11)
    small_sc = [random_field(rng, FR, (n_small - k,), dev) for k in (0, 2, 5)]
    full, rest = small_tabs.launch_groups(n_small)
    g_small = full * 256 + rest
    sc3 = torch.zeros((16, 3, 8 * g_small), dtype=torch.int32, device=dev)
    for i, sv in enumerate(small_sc):
        sc3[:, i, : sv.shape[-1]] = sv
    # (W = 1 is held at one chunk above: its plain version is 255 steps however few the lanes)
    want = [g1_vec.point_from_device(msm.msm_bitserial(
        tuple(c[:, : sv.shape[-1]].contiguous() for c in srs_pts), sv)) for sv in small_sc]
    for windows in (1, 4, 16):
        got = msm_fixed.msm_fixed_horner(small_tabs.tables(), sc3, windows)
        assert got[0].shape == (24, 3, windows, g_small)
        if windows > 1:
            assert max_abs_err(got, msm_fixed.msm_fixed_plain(small_tabs.tables(), sc3, windows)) == 0, (
                f"msm_fixed_horner differs from its plain version at W = {windows}")
        commit = g1_vec.points_from_device(small_tabs.msm_many(small_sc, windows=windows))
        assert commit == want, f"the commit at W = {windows} differs from the bit-serial MSM"
    win = g1_vec.combine_partials(got)  # (24, 3, 16)
    join_err = max_abs_err(msm_fixed.msm_join(win, 16), msm_fixed.msm_join_plain(win, 16))
    join_plain_ms = cuda_ms(lambda: msm_fixed.msm_join_plain(win, 16), 1, warm=False)
    print(f"  msm_fixed_horner, 3 sets of 2^11 + 6 scalars ({g_small} groups), W in 4, 16: exact; commits at W in "
          "1, 4, 16 equal the bit-serial MSM's; msm_join (3 sets, 16 windows): exact", flush=True)
    # the shapes the prove gives it: 3 sets and 1 set of 2^16 + 2 scalars over
    # the tables of the 2^16 + 6-point SRS; each W timed (kernel, then join)
    tabs = msm_fixed.FixedBaseTables(srs_pts)
    tabs.tables()
    n_sc = (1 << 16) + 2
    full, rest = tabs.launch_groups(n_sc)
    g_path = full * groups + rest
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    timed_w = {}
    for P in (3, 1):
        sets = [random_field(rng, FR, (n_sc,), dev) for _ in range(P)]
        scp = torch.zeros((16, P, 8 * g_path), dtype=torch.int32, device=dev)
        for i, sv in enumerate(sets):
            scp[:, i, :n_sc] = sv
        chosen = msm_fixed.windows_for(P * g_path, dev)
        for windows in (1, 2, 4, 8, 16):
            lanes = P * windows * g_path
            k_ms = cuda_ms(lambda: msm_fixed.msm_fixed_horner(tabs.tables(), scp, windows), 3)
            wsum = tuple(c[:, : P * windows].reshape(24, P, windows).contiguous() for c in pts)
            j_ms = cuda_ms(lambda: msm_fixed.msm_join(wsum, msm_fixed.window_bits(windows)), 3) if windows > 1 else 0.0
            c_ms = cuda_ms(lambda: tabs.msm_many(sets, windows=windows), 3)
            timed_w[P, windows] = (k_ms, j_ms, c_ms)
            print(f"  msm_fixed_horner, {P} x (2^16 + 2) scalars, {g_path} groups, W = {windows}"
                  f"{' (chosen)' if windows == chosen else ''}: {lanes} lanes, {-(-lanes // 128)} blocks of 128 on "
                  f"{sms} SMs, kernel {k_ms:.4f} ms, join {j_ms:.4f} ms, whole commit {c_ms:.4f} ms", flush=True)
        if P == 3:
            w3, sc_path3 = chosen, scp
    nbytes, mads = horner_work(sc_path3, g_path, w3)
    record("msm_fixed_horner", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/pallas_kernels.py:242", "msm_fixed.msm_fixed_horner",
           one_chunk["err"], (timed_w[3, w3][0], host_us(lambda: msm_fixed.msm_fixed_horner(tabs.tables(), sc_path3, w3), 3)),
           one_chunk["plain_ms"], nbytes, mads,
           shape=f"3 x (2^16 + 2) scalars, {g_path} groups, W = {w3}", windows=w3,
           join_ms=timed_w[3, w3][1], commit_ms=timed_w[3, w3][2],
           ms_one_set=timed_w[1, msm_fixed.windows_for(g_path, dev)][0],
           ms_one_chunk=one_chunk["ms"], bound_ms_one_chunk=one_chunk["bound_ms"],
           plain_shape="one 2^14-point chunk, 1 set, W = 1")
    s_w = msm_fixed.window_bits(w3)
    record("msm_fixed_join", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/pallas_kernels.py:242", "msm_fixed.msm_join", join_err,
           (timed_w[3, w3][1], host_us(lambda: msm_fixed.msm_join(win, 16), 3)), join_plain_ms, 6 * FQ_BYTES * 3 * w3,
           3 * (w3 - 1) * (DOUBLE_MADS * s_w + FQ_MUL * ADD_MULS),
           shape=f"3 sets, {w3} windows of {s_w} bits", plain_shape="3 sets, 16 windows of 16 bits")
    # -- the addition on one lane of shape (24,): its device time is the
    # latency of one addition, the depth floor's unit. No prove launches the
    # elementwise addition since the Pippenger MSM has its own kernels: its
    # rows are off every path
    one_a, one_b = (tuple(c[:, i].contiguous() for c in pts) for i in (1, 2))
    one64 = tuple(tuple(c.to(torch.int64) for c in q) for q in (one_a, one_b))
    add_ms, add_us = timed(lambda: g1_vec.padd(one_a, one_b), 100)
    record("g1_padd", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/g1_vec.py:132", "g1_vec.padd",
           max_abs_err(g1_vec.padd(one_a, one_b), g1_vec.padd_plain(*one64)), (add_ms, add_us),
           cuda_ms(lambda: g1_vec.padd_plain(*one64), 5), 9 * FQ_BYTES, FQ_MUL * ADD_MULS, run="off",
           shape="one lane (24,)")

    # -- the group tree at the fixed-base commit's shapes: the Horner partials
    # of 3 sets at the chosen W, their 4 whole chunks of 2048 groups as the
    # commit's (24, 3, W, 4, 2048) view of them (read in place), then the
    # chunk combine (24, 3, W, 8): the 4 chunk sums, the rest's group and 3
    # identities. Bound: n - 1 additions a set, n points read and one written;
    # beside it the depth floor, log2(n) dependent additions of add_ms each
    part = msm_fixed.msm_fixed_horner(tabs.tables(), sc_path3, w3)  # (24, 3, W, g_path)
    full = g_path // groups
    whole = tuple(c[..., : full * groups].reshape(24, 3, w3, full, groups) for c in part)
    tail = tuple(c[..., full * groups :] for c in part)
    ident = g1_vec.pidentity((3, w3, 8 - full - tail[0].shape[-1]), dev)
    before = (g1_vec.tree_reduce.launches, g1_vec.padd.launches)
    sums = g1_vec.tree_reduce(whole)
    assert (g1_vec.tree_reduce.launches, g1_vec.padd.launches) == (before[0] + 1, before[1]), (
        "tree_reduce is one launch of the tree kernel and no addition launch")
    combine_in = tuple(torch.cat([s, t, e], dim=-1) for s, t, e in zip(sums, tail, ident))
    for label, p in (("", whole), (" (combine)", combine_in)):
        want, plain_ms = once_ms(lambda: g1_vec.tree_reduce_plain(p))
        n_t, sets_t = p[0].shape[-1], p[0][0].numel() // p[0].shape[-1]
        levels, plan = n_t.bit_length() - 1, g1_vec.tree_plan(n_t, sets_t, sms)
        nbytes, mads = tree_work(n_t, sets_t)
        ms, host = timed(lambda: g1_vec.tree_reduce(p), 20)
        floor_ms = max(levels * add_ms, bound(nbytes, mads)[0])
        record(f"g1_tree{label}", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/g1_vec.py:298",
               "g1_vec.tree_reduce", max_abs_err(g1_vec.tree_reduce(p), want), (ms, host), plain_ms, nbytes, mads,
               shape=str(tuple(p[0].shape)), levels=levels, depth_floor_ms=levels * add_ms, add_ms=add_ms,
               share_of_floor=floor_ms / ms, plan=plan)
        print(f"  g1_tree{label} {tuple(p[0].shape)}: depth floor {levels} x {add_ms:.4f} ms = "
              f"{levels * add_ms:.4f} ms, share of the larger floor {floor_ms / ms:.2f}; plan (B, sets a block) "
              f"{plan}", flush=True)
    del tabs, small_tabs, part, whole, tail, combine_in
    # the shapes the Pippenger scans gave the addition before the Pippenger
    # kernels: the 65,538 sorted points of a commit and the 2^14 buckets of a
    # window
    n_scan = (1 << 16) + 2
    for lanes, label in ((n_scan, "65538 lanes"), (chunk, "2^14 lanes")):
        pa = tuple(torch.cat([c] * (lanes // chunk) + [c[:, : lanes % chunk]], dim=1) for c in pts)
        pb = tuple(c.roll(1, dims=1) for c in pa)
        pa64, pb64 = (tuple(c.to(torch.int64) for c in q) for q in (pa, pb))
        record(f"g1_padd ({label})", "baby_plonk_tpu_torch/csrc/g1.cu",
               "baby_plonk_tpu/ops/g1_vec.py:132", "g1_vec.padd",
               max_abs_err(g1_vec.padd(pa, pb), g1_vec.padd_plain(pa64, pb64)),
               timed(lambda: g1_vec.padd(pa, pb), 20),
               cuda_ms(lambda: g1_vec.padd_plain(pa64, pb64), 2),
               9 * FQ_BYTES * lanes, FQ_MUL * ADD_MULS * lanes, run="off")
    pa = pb = pa64 = pb64 = None
    # one MSM at 2^10 against the exact host oracle
    m = 1 << 10
    host_pts = g1_vec.points_from_device(tuple(c[:, :m] for c in pts))
    host_sc = limbs.FR.unpack_raw(scal[:, 0, :m])
    tabs = msm_fixed.FixedBaseTables(tuple(c[:, :m] for c in pts), chunk=m)
    got = g1_vec.point_from_device(tabs.msm(scal[:, 0, :m].contiguous()))
    assert got == msm_host.msm(host_pts, host_sc), "fixed-base MSM differs from the host MSM"
    print("  fixed-base MSM 2^10 == curves.msm_host.msm", flush=True)

    # -- variable-base MSM: one 2^14-point chunk, a ragged shape, the prove's ----
    sc1 = scal[:, 0].contiguous()
    tile = msm.TILE

    def partials_work(sc, n):
        """(bytes, multiply-adds): per lane 254 doublings and one addition
        per set bit, then the in-tile tree."""
        tiles = -(-n // tile)
        return ((3 * FQ_BYTES + FR_BYTES) * n + 3 * FQ_BYTES * tiles,
                DOUBLE_MADS * 254 * n + FQ_MUL * ADD_MULS * (popcount(sc) + tiles * (tile - 1)))

    err = max_abs_err(msm.msm_partials(pts, sc1), msm.msm_partials_plain(pts, sc1))
    chunk_ms = cuda_ms(lambda: msm.msm_partials(pts, sc1), 3)
    chunk_plain_ms = cuda_ms(lambda: msm.msm_partials_plain(pts, sc1), 1, warm=False)
    assert err == 0, "msm_partials differs from its plain version on one chunk"
    # a chunk of zero scalars: the kernel runs the doublings and the tree, and
    # no addition in the bit loop
    zeros = torch.zeros_like(sc1)
    assert max_abs_err(msm.msm_partials(pts, zeros), msm.msm_partials_plain(pts, zeros)) == 0, (
        "msm_partials differs from its plain version on zero scalars")
    # n no multiple of the tile: the last tile's lanes past n keep the identity
    n_small = (1 << 11) + 6
    rag = (tuple(c[:, :n_small].contiguous() for c in pts), sc1[:, :n_small].contiguous())
    got = msm.msm_partials(*rag)
    assert got[0].shape == (24, -(-n_small // tile))
    assert max_abs_err(got, msm.msm_partials_plain(*rag)) == 0, (
        "msm_partials differs from its plain version at n = 2^11 + 6")
    print(f"  msm_partials, one 2^14-point chunk (tile {tile}): exact, kernel {chunk_ms:.4f} ms, plain "
          f"{chunk_plain_ms:.1f} ms; zero scalars: exact, kernel "
          f"{cuda_ms(lambda: msm.msm_partials(pts, zeros), 3):.4f} ms; n = 2^11 + 6: exact",
          flush=True)
    # the shape the bit-serial prove gives it: 65,538 points in one launch
    n_path = (1 << 16) + 2
    path_pts = tuple(c[:, :n_path].contiguous() for c in srs_pts)
    path_sc = random_field(rng, FR, (n_path,), dev)
    by_tile = {t: cuda_ms(lambda: msm.msm_partials(path_pts, path_sc, tile=t), 3) for t in (128, 256)}
    print(f"  msm_partials, 65538 points in one launch: " + ", ".join(
        f"tile {t}: {-(-n_path // t)} blocks, {ms:.4f} ms" for t, ms in by_tile.items())
        + f"; whole MSM {cuda_ms(lambda: msm.msm_bitserial(path_pts, path_sc), 3):.4f} ms", flush=True)
    nbytes, mads = partials_work(path_sc, n_path)
    record("msm_partials", "baby_plonk_tpu_torch/csrc/msm.cu",
           "baby_plonk_tpu/ops/pallas_kernels.py:107", "msm.msm_partials", err,
           (by_tile[tile], host_us(lambda: msm.msm_partials(path_pts, path_sc), 3)), chunk_plain_ms, nbytes, mads,
           run="bitserial",
           shape=f"65538 points, tile {tile}, one launch", ms_one_chunk=chunk_ms,
           bound_ms_one_chunk=bound(*partials_work(sc1, chunk))[0],
           plain_shape="one 2^14-point chunk")
    # the doubling's shape: one point, the doubling chain of the SRS's table
    # of multiples (24, 1), 255 launches on the main path
    pt1 = tuple(c[:, 1].contiguous() for c in pts)
    pt64 = tuple(c.to(torch.int64) for c in pt1)
    assert pt1[0].shape == (24,)
    dbl_ms, dbl_us = timed(lambda: g1_vec.pdouble(pt1), 100)
    record("g1_pdouble", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/g1_vec.py:165",
           "g1_vec.pdouble", max_abs_err(g1_vec.pdouble(pt1), g1_vec.pdouble_plain(pt64)),
           (dbl_ms, dbl_us), cuda_ms(lambda: g1_vec.pdouble_plain(pt64), 5),
           6 * FQ_BYTES, DOUBLE_MADS)

    # -- the Pippenger MSM: one bpt_msm_pippenger call (a few launches) against
    # its plain version under the same plan, limb for limb, at the prove's
    # 65,538 points (c = 14), at 2^14 points (c = 12) and on skewed scalars:
    # all equal (one bucket a window holds every point) and a run of 1000
    # equal scalars across many chunks. Device time by CUDA events (the call
    # takes milliseconds; the sort, glue, is inside it), each kernel's by
    # torch.profiler. Beside the bound, the latency floor: the Horner chain,
    # c (nwin - 1) dependent doublings and nwin - 1 additions on one thread,
    # at the one-lane g1_pdouble and g1_padd rows' device times
    PIP_CU = "baby_plonk_tpu_torch/csrc/pippenger.cu"
    skew_all = path_sc[:, :1].expand(16, n_path).contiguous()
    skew_run = path_sc.clone()
    skew_run[:, 5000:6000] = path_sc[:, 5000:5001]
    pip = {}
    for label, p, s in (("65538", path_pts, path_sc), ("2^14", pts, sc1),
                        ("all equal", path_pts, skew_all), ("run of 1000", path_pts, skew_run)):
        n_p = s.shape[-1]
        c = msm_pippenger.window_c(n_p)
        plan = msm_pippenger.make_plan(n_p, c, sms)
        before = msm_pippenger.msm_pippenger.launches
        got = msm_pippenger.msm_pippenger(p, s)
        assert msm_pippenger.msm_pippenger.launches == before + 1, "the Pippenger MSM is one bpt_msm_pippenger call"
        want, plain_ms = once_ms(lambda: msm_pippenger.msm_pippenger_plain(p, s, c, plan))
        err = max_abs_err(got, want)
        assert err == 0, f"bpt_msm_pippenger differs from its plain version ({label}, max |err| {err})"
        nwin = msm_pippenger.windows(c)
        ds = msm_pippenger.sorted_digits(s, c)[0]
        pip[label] = {"err": err, "plain_ms": plain_ms, "plan": plan, "work": pippenger_work(ds, c),
                      "ms": cuda_ms(lambda: msm_pippenger.msm_pippenger(p, s), 5),
                      "floor_ms": c * (nwin - 1) * dbl_ms + (nwin - 1) * add_ms,
                      "levels": len(msm_pippenger.levels(n_p, *plan[:2]))}
        print(f"  msm_pippenger, {label} points/scalars, c = {c}, plan (K, JOIN_K, L, BS) {plan}, "
              f"{pip[label]['levels']} walk levels: exact, {pip[label]['ms']:.4f} ms (events), plain "
              f"{plain_ms:.1f} ms, bound {bound(*pip[label]['work'])[0]:.4f} ms, latency floor "
              f"{pip[label]['floor_ms']:.4f} ms", flush=True)
    # other window widths (the default is the reference's c = 14) and plans at
    # the prove's 65,538 points: the same point, and each call's time
    want_pt = g1_vec.point_from_device(msm_pippenger.msm_pippenger(path_pts, path_sc))
    alt = {}
    for c, plan in ((12, None), (13, None), (15, None), (16, None), (14, (19, 8, 16, 128)), (14, (74, 8, 16, 128)),
                    (14, (37, 4, 16, 128)), (14, (37, 8, 8, 128)), (14, (37, 8, 32, 128))):
        key = f"c = {c}" + ("" if plan is None else f", plan {plan}")
        assert g1_vec.point_from_device(msm_pippenger.msm_pippenger(path_pts, path_sc, c, plan)) == want_pt, key
        alt[key] = cuda_ms(lambda: msm_pippenger.msm_pippenger(path_pts, path_sc, c, plan), 5)
    print(f"  msm_pippenger, 65538 points, other widths and plans (same point; ms, events): {json.dumps(alt)}",
          flush=True)
    names = ("repack_kernel", "walk_kernel", "segment_kernel", "window_kernel", "horner_kernel")
    by_kernel = kernel_ms(lambda: msm_pippenger.msm_pippenger(path_pts, path_sc), names)
    print(f"  msm_pippenger, 65538 points, device ms by kernel: {json.dumps(by_kernel)}", flush=True)
    main_pip = pip["65538"]
    record("msm_pippenger", PIP_CU, "baby_plonk_tpu/ops/msm_pippenger.py:45", "msm_pippenger.msm_pippenger",
           main_pip["err"], timed_events(lambda: msm_pippenger.msm_pippenger(path_pts, path_sc), 5),
           main_pip["plain_ms"], *main_pip["work"], run="pippenger",
           shape="65538 points, c = 14, one call", plan=main_pip["plan"], levels=main_pip["levels"],
           latency_floor_ms=main_pip["floor_ms"], kernel_ms=by_kernel, other_widths_and_plans_ms=alt,
           **{f"ms_{k.replace(' ', '_').replace('^', '_')}": v["ms"] for k, v in pip.items() if k != "65538"},
           **{f"bound_ms_{k.replace(' ', '_').replace('^', '_')}": bound(*v["work"])[0]
              for k, v in pip.items() if k != "65538"})
    del path_pts, srs_pts, skew_all, skew_run
    # both variable-base algorithms at 2^10 against the exact host oracle, and
    # one 2^14-point Pippenger MSM timed beside the bit-serial chunk
    want = msm_host.msm(host_pts, host_sc)
    small = (tuple(c[:, :m].contiguous() for c in pts), sc1[:, :m].contiguous())
    assert g1_vec.point_from_device(msm.msm_bitserial(*small)) == want, "bit-serial MSM differs from the host MSM"
    assert g1_vec.point_from_device(msm_pippenger.msm_pippenger(*small)) == want, "Pippenger MSM differs from the host MSM"
    print("  bit-serial and Pippenger MSM 2^10 == curves.msm_host.msm", flush=True)
    pip = g1_vec.point_from_device(msm_pippenger.msm_pippenger(pts, sc1))
    assert pip == g1_vec.point_from_device(msm.msm_bitserial(pts, sc1)), "Pippenger and bit-serial differ at 2^14"
    print(f"  one 2^14-point MSM: bit-serial {cuda_ms(lambda: msm.msm_bitserial(pts, sc1), 2):.3f} ms, "
          f"Pippenger (c = {msm_pippenger.window_c(chunk)}) "
          f"{cuda_ms(lambda: msm_pippenger.msm_pippenger(pts, sc1), 2):.3f} ms (equal points)", flush=True)


def msm_times(dev):
    """The commit MSMs at the shapes a 2^16-gate prove gives them: 3 sets and
    1 set of 2^16 + 2 scalars through ``FixedBaseTables.msm_many`` over the
    2^16 + 6-point SRS, and 65,538 points through ``msm.msm_device_arrays``
    (bit-serial), with the launches each makes; the group tree alone over
    the fixed-base commit's whole chunks of Horner partials, and a digest of
    the commits' coordinates, which every version must give alike."""
    import hashlib

    import numpy as np
    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops import g1_vec, limbs, msm, msm_fixed, srs

    rng = np.random.default_rng(SEED)
    n_sc = (1 << 16) + 2
    pts = srs.powers_of_tau(srs.tau_scalars(n_sc + 4, TAU, dev), srs.generator_base(dev))
    tabs = msm_fixed.FixedBaseTables(pts)
    out = {}
    digest = hashlib.sha256()
    for P in (3, 2, 1):  # the sets of a prove's four commits: 3, 1, 3, 2
        sets = [random_field(rng, limbs.FR, (n_sc,), dev) for _ in range(P)]
        for c in tabs.msm_many(sets):
            digest.update(c.cpu().numpy().tobytes())
        tree = getattr(g1_vec.tree_reduce, "launches", 0)  # a counter since the tree kernel
        before = msm_fixed.msm_fixed_horner.launches, g1_vec.padd.launches, tree
        out[f"fixed_base_commit_{P}_sets_ms"] = cuda_ms(lambda: tabs.msm_many(sets), 5)
        out[f"fixed_base_commit_{P}_sets_horner_launches"] = (msm_fixed.msm_fixed_horner.launches - before[0]) // 6
        out[f"fixed_base_commit_{P}_sets_padd_launches"] = (g1_vec.padd.launches - before[1]) // 6
        out[f"fixed_base_commit_{P}_sets_tree_launches"] = (
            getattr(g1_vec.tree_reduce, "launches", 0) - before[2]) // 6
        # the tree over the commit's whole chunks, (24, P, W, 4, 2048)
        full, rest = tabs.launch_groups(n_sc)
        gc = tabs.chunk // msm_fixed.GROUP
        G = full * gc + rest
        W = msm_fixed.windows_for(P * G, dev)
        sc = torch.zeros((16, P, G * msm_fixed.GROUP), dtype=torch.int32, device=dev)
        for i, sv in enumerate(sets):
            sc[:, i, :n_sc] = sv
        part = msm_fixed.msm_fixed_horner(tabs.tables(), sc, W)
        whole = tuple(c[..., : full * gc].reshape(24, P, W, full, gc) for c in part)
        out[f"tree_{P}_sets_shape"] = str(tuple(whole[0].shape))
        out[f"tree_{P}_sets_ms"] = cuda_ms(lambda: g1_vec.tree_reduce(whole), 10)
    out["fixed_base_commits_sha256"] = digest.hexdigest()
    prev = config.get_config()
    config.set_config(config.Config(commit_fixed_base=False, msm_algorithm="bitserial"))
    try:
        vpts, vsc = tuple(c[:, :n_sc].contiguous() for c in pts), sets[0]
        before = msm.msm_partials.launches
        out["bitserial_commit_ms"] = cuda_ms(lambda: msm.msm_device_arrays(vpts, vsc), 3)
        out["bitserial_commit_partials_launches"] = (msm.msm_partials.launches - before) // 4
        got = g1_vec.point_from_device(msm.msm_device_arrays(vpts, vsc))
    finally:
        config.set_config(prev)
    assert got == g1_vec.point_from_device(tabs.msm(vsc)), "bit-serial and fixed-base commits differ"
    print(json.dumps({"msm_times": out}), flush=True)


def setup_times(dev):
    """The two set-up kernels at the main path's shapes, through entry points
    that every version of the package has (copy the script beside an older
    package to time that one on the same card): ``srs.powers_of_tau`` of the
    generator over 2^16 + 6 and 2^10 lanes, its first call in the process
    (which builds the table of multiples, where the version has one) and
    later calls; the fixed-base tables of the 2^16 + 6-point SRS (8193
    groups, as ``FixedBaseTables`` pads them) and of one 2^14-point chunk;
    and a digest of the SRS's tables, which every version must give alike
    (affine entries are unique)."""
    import hashlib

    import torch

    from baby_plonk_tpu_torch.ops import msm_fixed, srs

    out = {}
    base = srs.generator_base(dev)
    n = (1 << 16) + 6
    sc = srs.tau_scalars(n, TAU, dev)
    sc10 = sc[:, : 1 << 10].contiguous()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pts = srs.powers_of_tau(sc, base)
    torch.cuda.synchronize()
    out["powers_of_tau_first_call_ms"] = (time.perf_counter() - t) * 1e3
    out["powers_of_tau_65542_ms"] = cuda_ms(lambda: srs.powers_of_tau(sc, base), 5)
    out["powers_of_tau_1024_ms"] = cuda_ms(lambda: srs.powers_of_tau(sc10, base), 5)
    if hasattr(srs, "base_tables"):
        def fresh_table():
            srs.base_tables.clear()
            return srs.base_table(base)
        out["table_of_multiples_ms"] = cuda_ms(fresh_table, 3)
    tabs = msm_fixed.FixedBaseTables(pts)
    out["tables_8193_groups_ms"] = cuda_ms(lambda: msm_fixed.FixedBaseTables(pts).tables(), 3)
    chunk = tuple(c[:, : msm_fixed.CHUNK].contiguous() for c in pts)
    out["tables_one_chunk_ms"] = cuda_ms(lambda: msm_fixed.build_tables(*chunk), 3)
    out["srs_tables_sha256"] = hashlib.sha256(tabs.tables().cpu().numpy().tobytes()).hexdigest()
    print(json.dumps({"setup_times": out}), flush=True)


class Count:
    """A wrapper's count kept under ``attr``: a wrapper of two forms counts
    each apart (``round3_combine``: ``launches``, ``launches_zw``)."""

    def __init__(self, fn, attr):
        self.fn, self.attr = fn, attr

    @property
    def launches(self):
        return getattr(self.fn, self.attr)

    @launches.setter
    def launches(self, value):
        setattr(self.fn, self.attr, value)


def kernel_counters():
    """Every wrapper of the paths, by name: its ``launches`` count."""
    from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm, msm_fixed, msm_pippenger, prover_kernels, srs

    return {
        "limbs.mont_mul": limbs.mont_mul, "limbs.add_mod": limbs.add_mod,
        "limbs.sub_mod": limbs.sub_mod, "limbs.to_mont": limbs.to_mont,
        "limbs.from_mont": limbs.from_mont, "limbs.mont_pow_fixed": limbs.mont_pow_fixed,
        "limbs.field_scan": limbs.field_scan, "limbs.pow_table": limbs.pow_table,
        "prover_kernels.round3_combine": prover_kernels.round3_combine,
        "prover_kernels.round3_combine (zw)": Count(prover_kernels.round3_combine, "launches_zw"),
        "prover_kernels.grand_product_fg": prover_kernels.grand_product_fg,
        "kernels.ntt_sub": kernels.ntt_sub,
        "kernels.ntt_sub_4step": kernels.ntt_sub_4step, "g1_vec.padd": g1_vec.padd,
        "g1_vec.tree_reduce": g1_vec.tree_reduce,
        "msm_fixed.build_tables": msm_fixed.build_tables,
        "msm_fixed.msm_fixed_horner": msm_fixed.msm_fixed_horner,
        "msm_fixed.msm_join": msm_fixed.msm_join,
        "srs.powers_of_tau": srs.powers_of_tau,
        "msm.msm_partials": msm.msm_partials, "g1_vec.pdouble": g1_vec.pdouble,
        "msm_pippenger.msm_pippenger": msm_pippenger.msm_pippenger,
    }


def watch_cpu_calls():
    """Count the wrapper calls that take the plain path (``kernels.on_cpu``
    true); returns the one-entry list that holds the count and the real
    ``on_cpu`` to put back."""
    from baby_plonk_tpu_torch.ops import kernels

    plain_calls = [0]
    real_on_cpu = kernels.on_cpu

    def watched(*tensors):
        cpu = real_on_cpu(*tensors)
        plain_calls[0] += cpu
        return cpu

    kernels.on_cpu = watched
    return plain_calls, real_on_cpu


def counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def main_path(dev, n, counters):
    """Phase 4. Returns the counts of the whole run and of the warm prove,
    the setup, program, witness and public input for phase 6, and the cold
    and warm prove's seconds."""
    import torch

    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier, mul_chain
    from baby_plonk_tpu_torch.utils.metrics import get_metrics

    from baby_plonk_tpu_torch.ops import srs

    zero_counts(counters)
    srs.base_tables.clear()  # the SRS builds the generator's table as a fresh process does
    t = time.perf_counter()
    setup = Setup.generate_srs_device(n + 6, TAU, cache=False, device=dev)
    torch.cuda.synchronize()
    phase("main: device SRS 2^16+6", t)
    t = time.perf_counter()
    constraints, witness, public = mul_chain(n)
    program = Program.from_strs(constraints, n)
    phase("main: circuit + program (host)", t)
    engine = TorchEngine(dev)
    get_metrics().reset()
    t = time.perf_counter()
    Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    phase("main: cold prove", t, f"spans: {get_metrics().report()}")
    get_metrics().reset()
    before = counts(counters)
    t = time.perf_counter()
    proof = Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    phase("main: warm prove", t, f"spans: {get_metrics().report()}")
    # 9 polynomials of 2^16 + 2..6 coefficients = 8193 groups each, times the windows
    horner = get_metrics().counters
    print(f"  Horner groups and lanes in the warm prove: {horner['horner_groups']}, {horner['horner_lanes']}", flush=True)
    warm_counts = {k: v - before[k] for k, v in counts(counters).items()}
    t = time.perf_counter()
    ok = Verifier(setup, program, proof, engine=engine).verify(public)
    verify_s = time.perf_counter() - t
    phase("main: verify (incl. 8 preprocessed commits)", t, f"-> {ok}")
    assert ok, "the 2^16 proof does not verify"
    assert len(proof.to_bytes()) == 624
    wrong = [(public[0] + 1) % (1 << 255)]
    assert not Verifier(setup, program, proof, engine=engine).verify(wrong), "wrong public accepted"
    print("  wrong public input rejected", flush=True)
    print(f"  seconds: cold prove {cold:.3f}, warm prove {warm:.3f}, verify {verify_s:.3f}", flush=True)
    run_counts = counts(counters)
    profile_prove(lambda: Prover(setup, program, engine).prove(witness), warm)
    return run_counts, warm_counts, (setup, program, witness, public), (cold, warm)


def profile_prove(prove, warm_s):
    """Warm proves under torch.profiler: device time by kernel name, and the
    busy share, the device time over the ``warm_s`` seconds that the warm
    prove took without the profiler (tracing slows the host). The tracer now
    and then loses the records of a window (half the kernels of a prove), so
    the prove is profiled until two totals agree within 15%, four times at
    most, and the larger reading is the one reported."""
    from baby_plonk_tpu_torch.bench import profile_device

    readings, _ = profile_device(prove, tries=4)
    print(f"  device ms of the profiled proves: {', '.join(f'{r[0]:.1f}' for r in readings)}", flush=True)
    device_ms, rows, wall_ms, spans = max(readings, key=lambda r: r[0])
    assert device_ms > 0, "torch.profiler recorded no device time"
    print(f"  profiled warm prove: device {device_ms:.1f} ms, busy share {device_ms / (warm_s * 1e3):.3f} of the "
          f"{warm_s * 1e3:.1f} ms warm prove (wall with the profiler on: {wall_ms:.1f} ms); "
          f"spans: {spans}", flush=True)
    for name, count, ms in rows[:12]:
        print(f"    {ms:9.3f} ms  {count:5d} x  {name[:90]}", flush=True)
    assert not any("index" in r[0].lower() and "elect" in r[0].lower() for r in rows), (
        "an index_select kernel ran in the fixed-base prove")
    copies = {word: sum(r[1] for r in rows if word in r[0].lower()) for word in ("cat", "memcpy", "copy", "memset")}
    print("    torch copy and concatenation kernels: " + ", ".join(f"{v} x {k}" for k, v in copies.items()), flush=True)
    rest = rows[12:]
    print(f"    {sum(r[2] for r in rest):9.3f} ms  {sum(r[1] for r in rest):5d} x  ({len(rest)} other kernels)", flush=True)
    return {"device_ms": device_ms, "kernel_launches": sum(r[1] for r in rows), **copies}


def prove_profile(dev):
    """A warm 2^16-gate prove on the fixed-base path, through entry points
    that every version of the package has (copy the script beside an older
    package to profile that one on the same card): the elementwise addition
    and group-tree launches of the warm prove, and one profiled warm prove
    (device time, kernel launches, torch copy kernels by name)."""
    import torch

    from baby_plonk_tpu_torch.ops import g1_vec
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, mul_chain

    n = 1 << 16
    setup = Setup.generate_srs_device(n + 6, TAU, cache=False, device=dev)
    constraints, witness, _ = mul_chain(n)
    program = Program.from_strs(constraints, n)
    engine = TorchEngine(dev)
    Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    before = g1_vec.padd.launches, getattr(g1_vec.tree_reduce, "launches", 0)
    t = time.perf_counter()
    Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    out = {"warm_prove_s": warm, "padd_launches": g1_vec.padd.launches - before[0],
           "tree_launches": getattr(g1_vec.tree_reduce, "launches", 0) - before[1]}
    out.update(profile_prove(lambda: Prover(setup, program, engine).prove(witness), warm))
    print(json.dumps({"prove_profile": out}), flush=True)


def variable_base_path(dev, counters, circuit):
    """Phase 6. Returns the counts of the bit-serial and the Pippenger run,
    and the fixed-base proof's bytes."""
    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Prover, Verifier
    from baby_plonk_tpu_torch.utils.metrics import get_metrics

    setup, program, witness, public = circuit
    blinding = list(range(1, 12))
    engine = TorchEngine(dev)
    prev = config.get_config()
    proofs, run_counts = {}, {}
    try:
        for label, cfg in (
            ("fixed", config.Config(commit_fixed_base=True)),
            ("bitserial", config.Config(commit_fixed_base=False, msm_algorithm="bitserial")),
            ("pippenger", config.Config(commit_fixed_base=False, msm_algorithm="pippenger")),
        ):
            config.set_config(cfg)
            zero_counts(counters)
            get_metrics().reset()
            t = time.perf_counter()
            proof = Prover(setup, program, engine).prove(witness, blinding=blinding)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            run_counts[label] = counts(counters)
            proofs[label] = proof.to_bytes()
            print(f"  {label}: prove {seconds:.3f} s; spans: {get_metrics().report()}", flush=True)
            if label != "fixed":
                assert run_counts[label]["msm_fixed.msm_fixed_horner"] == 0, (
                    f"{label}: the fixed-base Horner kernel launched on the variable-base path")
                assert Verifier(setup, program, proof, engine=engine).verify(public), (
                    f"{label}: the 2^16 proof does not verify")
    finally:
        config.set_config(prev)
    assert run_counts["bitserial"]["msm.msm_partials"] == 9, (
        "the bit-serial prove is 9 commits, one msm_partials launch each")
    assert run_counts["pippenger"]["msm_pippenger.msm_pippenger"] == 9, (
        "the Pippenger prove is 9 commits, one bpt_msm_pippenger call each")
    assert run_counts["pippenger"]["g1_vec.padd"] == 0, "g1_padd launched in the Pippenger prove"
    assert run_counts["pippenger"]["g1_vec.pdouble"] == 0, "g1_pdouble launched in the Pippenger prove"
    assert run_counts["bitserial"]["msm_pippenger.msm_pippenger"] == 0, "the Pippenger kernels launched in the bit-serial prove"
    assert run_counts["bitserial"]["g1_vec.padd"] == 0, "g1_padd launched in the bit-serial prove"
    assert run_counts["pippenger"]["msm.msm_partials"] == 0, "the bit-serial kernel launched in the Pippenger prove"
    assert proofs["bitserial"] == proofs["pippenger"] == proofs["fixed"], (
        "the three commit configurations give different proof bytes")
    print("  proof bytes equal: fixed-base == bit-serial == Pippenger (624 bytes, fixed blinding)", flush=True)
    return run_counts["bitserial"], run_counts["pippenger"], proofs["fixed"]


def cross_engine(dev):
    """Phase 5: byte-identical proofs against the host engine at 2^8."""
    from baby_plonk_tpu_torch.ops.engine import HostEngine
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, mul_chain

    n = 1 << 8
    constraints, witness, _ = mul_chain(n)
    program = Program.from_strs(constraints, n)
    blinding = list(range(1, 12))
    port = Prover(Setup.generate_srs_device(n + 6, TAU, cache=False, device=dev), program, TorchEngine(dev)).prove(
        witness, blinding=blinding)
    host_setup = Setup.generate_srs(n + 6, TAU, cache=False)
    host = Prover(host_setup, program, engine=HostEngine()).prove(witness, blinding=blinding)
    assert port.to_bytes() == host.to_bytes(), "port and host engine proofs differ"


def setup_cache(dev, circuit, fixed_proof, cache_dir):
    """Phase 7: ``Setup.generate_srs_device(..., cache=True)`` twice on an
    empty cache directory: the first call computes and writes, the second
    reads. The points read back equal phase 4's, tensor for tensor, and a
    prove from them with phase 6's fixed blinding gives phase 6's
    fixed-base proof bytes."""
    import dataclasses

    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.bench import seconds
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Prover, Setup
    from baby_plonk_tpu_torch.protocol.setup import device_srs_path

    setup, program, witness, _ = circuit
    powers = setup.srs_len()
    prev = config.get_config()
    config.set_config(dataclasses.replace(prev, srs_cache_dir=cache_dir))
    try:
        path = device_srs_path(powers, TAU)
        assert not os.path.exists(path), "the cache directory is not empty"
        write_s, made = seconds(lambda: Setup.generate_srs_device(powers, TAU, cache=True, device=dev))
        load_s, loaded = seconds(lambda: Setup.generate_srs_device(powers, TAU, cache=True, device=dev))
        nbytes = os.path.getsize(path)
    finally:
        config.set_config(prev)
    want = setup.device_points[str(dev)]
    for other in (made, loaded):
        assert all(torch.equal(a, b) for a, b in zip(other.device_points[str(dev)], want)), (
            "the cached SRS differs from phase 4's")
        assert other.x_2 == setup.x_2 and other.srs_len() == powers
    print(f"  SRS of {powers} powers: computed and written {write_s:.4f} s, read back {load_s:.4f} s, "
          f"{nbytes} bytes; equal to phase 4's tensor for tensor", flush=True)
    proof = Prover(loaded, program, TorchEngine(dev)).prove(witness, blinding=list(range(1, 12)))
    assert proof.to_bytes() == fixed_proof, "the prove from the cached SRS gives other proof bytes"
    print("  prove from the SRS read back, fixed blinding: phase 6's fixed-base proof bytes", flush=True)


def mesh_checks(dev, mesh, setup):
    """Phase 9, the sharded functions at the prove's sizes against their
    single-device counterparts: the sharded powers of tau against the SRS,
    the distributed NTT (forward, inverse, dual) at 2^16 and 2^18 against
    ``ntt_device`` reordered by ``cyclic_perm``, both sharded MSMs over
    65,538 points against the single-device commit, and the sharded round-1
    step at 2^16 against ``TorchEngine``'s three commitments."""
    import numpy as np
    import torch

    from baby_plonk_tpu_torch.ops import g1_vec, limbs, msm_fixed, ntt, srs
    from baby_plonk_tpu_torch.ops.dpoly import DPoly
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.parallel import dmsm, dntt, prove_step
    from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
    from baby_plonk_tpu_torch.protocol.poly import Basis

    rng = np.random.default_rng(SEED + 9)
    FR = limbs.FR
    pts = srs.setup_points(setup, dev)
    powers = setup.srs_len()
    t = time.perf_counter()
    shards = srs.powers_of_tau_sharded(powers, TAU, mesh)
    got = tuple(mesh.gather([s[k] for s in shards])[:, :powers] for k in range(3))
    assert all(torch.equal(g, w) for g, w in zip(got, pts)), "the sharded powers of tau differ from the SRS"
    phase("mesh: powers_of_tau_sharded(2^16 + 6) == phase 4's SRS", t)

    t = time.perf_counter()
    for log2n in (16, 18):
        n = 1 << log2n
        x = random_field(rng, FR, (n,), dev)
        perm = torch.from_numpy(dntt.cyclic_perm(n, mesh.D)).to(dev)
        for inverse in (False, True):
            want = ntt.ntt_device(x, inverse).index_select(-1, perm)
            assert torch.equal(dntt.ntt_sharded(x, mesh, inverse), want), f"dNTT 2^{log2n} inverse={inverse}"
        cyc = dntt._local_fourstep(mesh.shard(x.reshape(16, 1, n)), mesh, False)
        assert torch.equal(mesh.gather(dntt._local_fourstep_dual(cyc, mesh)).reshape(16, n), x), "dual dNTT"
        print(f"  dNTT 2^{log2n}: forward and inverse == ntt_device reordered by cyclic_perm, dual round trip "
              f"exact; forward {cuda_ms(lambda: dntt.ntt_sharded(x, mesh), 5):.3f} ms against ntt_device "
              f"{cuda_ms(lambda: ntt.ntt_device(x), 5):.3f} ms (events, host time included)", flush=True)
    phase("mesh: distributed NTT", t)

    t = time.perf_counter()
    n_pts = (1 << 16) + 2
    sc = random_field(rng, FR, (n_pts,), dev)
    single = g1_vec.point_from_device(msm_fixed.tables_for_setup(setup, dev).msm(sc))
    entry = MeshEngine(mesh)._mesh_srs(setup)
    sc_shards = mesh.shard(torch.cat([sc, sc.new_zeros((16, entry["N"] - n_pts))], dim=-1))
    bitserial = g1_vec.point_from_device(dmsm.msm_sharded_arrays(entry["points"], sc_shards, mesh))
    tables = dmsm.build_tables_sharded(entry["points"], mesh)
    fixed = g1_vec.points_from_device(dmsm.msm_fixed_sharded(tables, [[s] for s in sc_shards], mesh))[0]
    assert bitserial == single and fixed == single, "a sharded MSM differs from the single-device commit"
    phase(f"mesh: msm_sharded_arrays and msm_fixed_sharded over {n_pts} points (SRS padded to {entry['N']}) "
          "== the single-device commit", t)

    t = time.perf_counter()
    n = 1 << 16
    cols = random_field(rng, FR, (3, n), dev)
    perm = torch.from_numpy(dntt.cyclic_perm(n, mesh.D)).to(dev)
    outs = prove_step.prove_step_sharded(cols, *(c[:, :n].index_select(-1, perm) for c in pts), mesh)
    engine = TorchEngine(dev)
    coeffs = engine.intt_polys([DPoly(cols[:, i].contiguous(), Basis.LAGRANGE) for i in range(3)])
    assert [g1_vec.point_from_device(o) for o in outs] == engine.commit_many(setup, coeffs), "prove_step_sharded"
    phase("mesh: prove_step_sharded 2^16 == TorchEngine's three commitments", t)


def mesh_path(dev, counters, circuit, fixed_proof):
    """Phase 9: the prover sharded over D = 4 shards on min(4, cards) cards.
    The sharded functions (``mesh_checks``), then MeshEngine proves of the
    2^16 circuit with phase 6's fixed blinding: cold and warm on the
    fixed-base path, one on the bit-serial path, each giving phase 6's
    fixed-base proof bytes and verifying; a wrong public input rejected;
    then a D = 8 prove at 2^12 (z(w x) on another shard in round 3) against
    TorchEngine's bytes. No CPU tensor reaches a wrapper on this path
    (``kernels.on_cpu`` is watched). Returns the counts of the fixed-base
    and the bit-serial run, and the cold and warm prove's seconds."""
    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops import kernels
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.parallel.mesh import make_mesh
    from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier, mul_chain
    from baby_plonk_tpu_torch.utils.metrics import get_metrics

    setup, program, witness, public = circuit
    blinding = list(range(1, 12))
    mesh = make_mesh(4)
    print(f"  mesh: D = {mesh.D} shards on {mesh.physical} card(s) (physical {mesh.physical}): {list(mesh.key)}",
          flush=True)
    plain_calls, real_on_cpu = watch_cpu_calls()
    prev = config.get_config()
    try:
        mesh_checks(dev, mesh, setup)
        assert plain_calls[0] == 0, f"{plain_calls[0]} wrapper calls on CPU tensors in the sharded functions"
        engine = MeshEngine(mesh)
        run_counts, seconds = {}, {}
        for label, cfg in (("fixed", config.Config(commit_fixed_base=True)),
                           ("bitserial", config.Config(commit_fixed_base=False, msm_algorithm="bitserial"))):
            config.set_config(cfg)
            zero_counts(counters)
            for turn in (("cold", "warm") if label == "fixed" else ("once",)):
                get_metrics().reset()
                t = time.perf_counter()
                proof = Prover(setup, program, engine).prove(witness, blinding=blinding)
                torch.cuda.synchronize()
                seconds[f"{label} {turn}"] = time.perf_counter() - t
                print(f"  mesh {label} prove ({turn}): {seconds[f'{label} {turn}']:.3f} s; "
                      f"spans: {get_metrics().report()}", flush=True)
                assert proof.to_bytes() == fixed_proof, f"mesh {label} prove: not phase 6's fixed-base proof bytes"
            assert Verifier(setup, program, proof, engine=engine).verify(public), f"mesh {label}: no verify"
            run_counts[label] = counts(counters)
        wrong = [(public[0] + 1) % (1 << 255)]
        assert not Verifier(setup, program, proof, engine=engine).verify(wrong), "mesh: wrong public accepted"
        print("  mesh proves == phase 6's fixed-base proof bytes (fixed-base and bit-serial), verify, "
              "wrong public input rejected", flush=True)
        config.set_config(prev)
        n = 1 << 12
        constraints, w12, _ = mul_chain(n)
        p12 = Program.from_strs(constraints, n)
        s12 = Setup.generate_srs_device(n + 6, TAU, cache=False, device=dev)
        want = Prover(s12, p12, TorchEngine(dev)).prove(w12, blinding=blinding).to_bytes()
        eight = MeshEngine(make_mesh(8))
        assert eight._can_shard(4 * n) and eight._can_shard(n)
        got = Prover(s12, p12, eight).prove(w12, blinding=blinding).to_bytes()
        assert got == want, "the D = 8 prove at 2^12 differs from TorchEngine's"
        print(f"  D = 8 over {eight.mesh.physical} card(s), 2^12: TorchEngine's proof bytes", flush=True)
        assert plain_calls[0] == 0, f"{plain_calls[0]} wrapper calls on CPU tensors on the mesh path"
    finally:
        kernels.on_cpu = real_on_cpu
        config.set_config(prev)
    for label, c in run_counts.items():
        print(f"  launches, mesh {label} run: {json.dumps(c)}", flush=True)
    for key in ("msm_fixed.msm_fixed_horner", "kernels.ntt_sub", "prover_kernels.round3_combine (zw)",
                "prover_kernels.grand_product_fg", "limbs.field_scan", "g1_vec.tree_reduce"):
        assert run_counts["fixed"][key] > 0, f"{key} did not launch in the mesh fixed-base run"
    assert run_counts["bitserial"]["msm.msm_partials"] > 0, "msm_partials did not launch in the mesh bit-serial run"
    assert run_counts["bitserial"]["g1_vec.tree_reduce"] > 0, "tree_reduce did not launch in the mesh bit-serial run"
    assert run_counts["bitserial"]["msm_fixed.msm_fixed_horner"] == 0, "Horner launched on the mesh bit-serial path"
    for c in run_counts.values():
        assert c["kernels.ntt_sub"] == 2 * c["kernels.ntt_sub_4step"], "every transform is two sub-NTT launches"
    return run_counts["fixed"], run_counts["bitserial"], (seconds["fixed cold"], seconds["fixed warm"]), mesh.physical


#: the kernels every MeshEngine run of phase 10 must launch, and those of
#: the fixed-base and the bit-serial commit path
MP_KERNELS = ("kernels.ntt_sub", "prover_kernels.round3_combine (zw)", "prover_kernels.grand_product_fg",
              "limbs.field_scan", "g1_vec.tree_reduce")
MP_COMMIT = {"fixed": "msm_fixed.msm_fixed_horner", "bitserial": "msm.msm_partials"}


def mp_worker(device, D, log2, expect_hex, srs_cache, runs):
    """One process of phase 10: the sharded round-1 step, then MeshEngine
    proves of the 2^log2 multiply chain over the process mesh of D shards
    (``runs``: "fixed cold", "fixed warm", "bitserial"; fixed blinding), each
    to ``expect_hex`` (else ``TorchEngine``'s bytes on this process's card),
    then verify and a wrong public input rejected. Every run must launch
    ``MP_KERNELS`` and its commit kernel (the sub-NTT twice a transform), and
    no wrapper may see a CPU tensor. Returns each run's seconds,
    cross-process collectives and bytes, and launches."""
    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops import kernels
    from baby_plonk_tpu_torch.parallel import multihost_smoke as mh
    from baby_plonk_tpu_torch.parallel.mesh import make_mesh
    from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine

    counters = kernel_counters()
    plain_calls, real_on_cpu = watch_cpu_calls()
    prev = config.get_config()
    try:
        mesh = make_mesh(D, device=device)
        mh.step_check(mesh)
        circ = mh.circuit(1 << log2, mesh.home, srs_cache, TAU)
        expect = bytes.fromhex(expect_hex) if expect_hex else mh.single_process_proof(circ, mesh.home)
        engine = MeshEngine(mesh)
        out = {"rank": mesh.rank, "D": D, "device": str(mesh.home), "shards": list(mesh.ids), "runs": {}}
        for label in runs:
            commit = label.split()[0]
            config.set_config(config.Config(commit_fixed_base=commit == "fixed", msm_algorithm="bitserial"))
            zero_counts(counters)
            proof, seconds, stats = mh.prove_checked(engine, circ, expect)
            c = counts(counters)
            for key in MP_KERNELS + (MP_COMMIT[commit],):
                assert c[key] > 0, f"rank {mesh.rank}, {label}: {key} did not launch"
            assert c["kernels.ntt_sub"] == 2 * c["kernels.ntt_sub_4step"], "every transform is two sub-NTT launches"
            assert c[MP_COMMIT["fixed" if commit == "bitserial" else "bitserial"]] == 0
            out["runs"][label] = {"s": seconds, **stats, "launches": c}
            print(f"rank {mesh.rank}: {mesh}: {label} prove at 2^{log2}, D = {D}: {seconds:.3f} s, "
                  f"{stats['collectives']} cross-process collectives, {stats['bytes']} bytes sent; "
                  "the expected proof bytes", flush=True)
        mh.verify_checked(engine, circ, proof)
        assert plain_calls[0] == 0, f"{plain_calls[0]} wrapper calls on CPU tensors in a worker"
        print(f"rank {mesh.rank}: verified, wrong public input rejected, no wrapper saw a CPU tensor", flush=True)
    finally:
        kernels.on_cpu = real_on_cpu
        config.set_config(prev)
    return out


def mp_path(dev, circuit, fixed_proof):
    """Phase 10: the prover over a ProcessMesh of two processes
    (``parallel/multihost_smoke.spawn``; ``mp_worker`` in each). The 2^16 +
    6 SRS is written to a fresh cache directory first and the workers read
    it. D = 4 (two shards a process) at 2^16: fixed-base cold and warm, then
    bit-serial, each to phase 6's fixed-base bytes; D = 8 (four a process)
    at 2^12, where round 3's z(w x) rows all cross processes, to
    TorchEngine's bytes. gloo on every card count; nccl too, one process a
    card, on two cards or more. Returns, by backend, the workers' results."""
    import dataclasses

    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.parallel import multihost_smoke
    from baby_plonk_tpu_torch.protocol import Setup

    cards = torch.cuda.device_count()
    backends = ("gloo", "nccl") if cards >= 2 else ("gloo",)
    if cards == 1:
        print("  one card: gloo, both processes on cuda:0 (NCCL refuses two ranks of one communicator on one "
              "card); the bytes in flight are staged through host memory, the kernels run on the card", flush=True)
    cache_dir = tempfile.mkdtemp(prefix="bpt_mp_srs_")
    prev = config.get_config()
    try:
        config.set_config(dataclasses.replace(prev, srs_cache_dir=cache_dir))
        Setup.generate_srs_device(circuit[0].srs_len(), TAU, cache=True, device=dev)
        config.set_config(prev)
        out = {}
        for backend in backends:
            t = time.perf_counter()
            four = multihost_smoke.spawn(mp_worker, (4, 16, fixed_proof.hex(), cache_dir,
                                                     ("fixed cold", "fixed warm", "bitserial")),
                                         2, backend, "cuda", 300)
            eight = multihost_smoke.spawn(mp_worker, (8, 12, None, None, ("fixed",)), 2, backend, "cuda", 300)
            phase(f"mp: {backend}, 2 processes, D = 4 at 2^16 and D = 8 at 2^12", t)
            for r in four + eight:
                print(f"  {backend}, rank {r['rank']} on {r['device']}, D = {r['D']}: " + "; ".join(
                    f"{label} {run['s']:.3f} s, {run['collectives']} collectives, {run['bytes']} bytes"
                    for label, run in r["runs"].items()), flush=True)
            out[backend] = four
    finally:
        config.set_config(prev)
        shutil.rmtree(cache_dir, ignore_errors=True)
    return out


#: the size of the reference's configuration: BASELINE.md's 2^20-gate proof
LARGE_LOG2 = 20


def round_peaks(prover, dev):
    """Wrap the five rounds of ``prover`` so that each records the most
    device memory torch has held allocated since the last reset of the peak,
    read when the round returns; returns the dict they fill."""
    import torch

    peaks = {}
    for k in range(1, 6):
        def wrapped(real=getattr(prover, f"round_{k}"), k=k):
            out = real()
            torch.cuda.synchronize(dev)
            peaks[f"round_{k}"] = torch.cuda.max_memory_allocated(dev)
            return out
        setattr(prover, f"round_{k}", wrapped)
    return peaks


def chunk_counts():
    """The position chunks so far of round 4's evaluations and of round 5's
    combination (``eval_many.chunks``, ``linear_combine_device.chunks``)."""
    from baby_plonk_tpu_torch.ops import dpoly, prover_kernels

    return {"eval": dpoly.eval_many.chunks, "combine": prover_kernels.linear_combine_device.chunks}


def chunks_since(start):
    return {k: v - start[k] for k, v in chunk_counts().items()}


def large_path(dev, counters, results):
    """Phase 11: the main path at 2^20 gates on one card, the reference's
    configuration (BASELINE.md: the 2^20-gate proof at one chip). Returns the
    counts of the 2^20 path (set-up, cold and warm prove, verify) and the
    cold and warm prove's seconds."""
    import numpy as np
    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops import dpoly, g1_vec, kernels, limbs, msm_fixed, ntt, prover_kernels, srs
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier, mul_chain
    from baby_plonk_tpu_torch.utils.metrics import get_metrics
    from baby_plonk_tpu_torch.utils.roofline import (FR_BYTES, FR_MUL, bound, horner_work, powers_of_tau_work,
                                                     tables_work, tree_work)

    rng = np.random.default_rng(SEED + LARGE_LOG2)
    FR = limbs.FR
    n = 1 << LARGE_LOG2
    m = 4 * n
    gib = 1 << 30
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)

    # -- the 2^20 path, its counts set to 0 just before it and read just after
    zero_counts(counters)
    composed0 = kernels.ntt_sub_4step.composed
    t = time.perf_counter()
    setup = Setup.generate_srs_device(n + 6, TAU, cache=False, device=dev)
    torch.cuda.synchronize()
    srs_s = time.perf_counter() - t
    t = time.perf_counter()
    constraints, witness, public = mul_chain(n)
    chain_s = time.perf_counter() - t
    t = time.perf_counter()
    program = Program.from_strs(constraints, n)
    program_s = time.perf_counter() - t
    t = time.perf_counter()
    program.common_preprocessed_input()
    cpi_s = time.perf_counter() - t
    tabs = msm_fixed.tables_for_setup(setup, dev)
    t = time.perf_counter()
    packed = tabs.tables()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t
    G, gc = packed.shape[0], tabs.chunk // msm_fixed.GROUP
    full, rest = tabs.launch_groups(n + 6)
    assert packed.shape == (full * gc + rest, 256, 24), f"the SRS's tables are {tuple(packed.shape)}"
    print(f"  set-up: device SRS 2^{LARGE_LOG2} + 6 {srs_s:.3f} s; mul_chain(2^{LARGE_LOG2}) {chain_s:.3f} s; Program.from_strs "
          f"{program_s:.3f} s; common_preprocessed_input {cpi_s:.3f} s; fixed-base tables of {G} groups "
          f"({packed.numel() * 4} bytes) {tables_s:.3f} s", flush=True)
    # a transform's first call builds its plan: each size and direction of the
    # prove, first call less second, as the bench's plan_s
    plan_s = {}
    for log2n in (LARGE_LOG2, LARGE_LOG2 + 2):
        x = torch.zeros((16, 1, 1 << log2n), dtype=torch.int32, device=dev)
        for inverse in (False, True):
            times = []
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                ntt.ntt_device(x, inverse)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            plan_s[f"2^{log2n} {'inverse' if inverse else 'forward'}"] = times[0] - times[1]
    del x
    print(f"  plans (first transform less second), s: {json.dumps(plan_s)}; in all {sum(plan_s.values()):.3f}",
          flush=True)

    engine = TorchEngine(dev)
    blinding = list(range(1, 12))
    proofs, seconds, peaks = {}, {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    before = None
    for label in ("cold", "warm"):
        if label == "warm":
            torch.cuda.reset_peak_memory_stats(dev)
            before = counts(counters)
            chunks0 = chunk_counts()
        prover = Prover(setup, program, engine)
        peaks[label] = round_peaks(prover, dev)
        get_metrics().reset()
        t = time.perf_counter()
        proof = prover.prove(witness, blinding=blinding)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t
        proofs[label] = proof.to_bytes()
        phase(f"2^{LARGE_LOG2}: {label} prove", t, f"spans: {get_metrics().report()}")
        print(f"  2^{LARGE_LOG2} {label} prove: device memory after each round (max allocated since the "
              f"{'cold prove' if label == 'cold' else 'warm prove'} began), GiB: "
              + ", ".join(f"{k} {v / gib:.3f}" for k, v in peaks[label].items()), flush=True)
    default_chunks = chunks_since(chunks0)
    resident_warm = torch.cuda.memory_allocated(dev)
    warm_counts = {k: v - before[k] for k, v in counts(counters).items()}
    assert proofs["cold"] == proofs["warm"], "the cold and warm 2^20 proofs differ under one blinding"
    assert len(proofs["warm"]) == 624, "a proof is 624 bytes"
    t = time.perf_counter()
    ok = Verifier(setup, program, proof, engine=engine).verify(public)
    verify_s = time.perf_counter() - t
    phase(f"2^{LARGE_LOG2}: verify (incl. 8 preprocessed commits)", t, f"-> {ok}")
    assert ok, "the 2^20 proof does not verify"
    assert not Verifier(setup, program, proof, engine=engine).verify([(public[0] + 1) % (1 << 255)]), (
        "a wrong public input was accepted at 2^20")
    print("  2^20: 624-byte proof verifies; a wrong public input rejected", flush=True)
    large_counts = counts(counters)
    composed = kernels.ntt_sub_4step.composed - composed0
    print(f"  launches, 2^20 path: {json.dumps(large_counts)}; transforms through the composed passes: {composed}",
          flush=True)
    assert large_counts["kernels.ntt_sub"] == 2 * (large_counts["kernels.ntt_sub_4step"] - composed), (
        "a transform is two sub-NTT launches, a composed one four (its two inner transforms)")
    print(f"  launches, 2^20 warm prove: {json.dumps(warm_counts)}", flush=True)
    assert warm_counts["msm_fixed.msm_fixed_horner"] == 4, "a warm prove is 4 commit rounds, one Horner launch each"
    assert warm_counts["g1_vec.tree_reduce"] == 3 * 4, "a warm prove's 4 commits are 3 tree launches each"
    assert warm_counts["g1_vec.padd"] == 0, "the elementwise addition launched in the 2^20 prove"
    assert warm_counts["prover_kernels.round3_combine"] == warm_counts["prover_kernels.grand_product_fg"] == 1
    for key in ("limbs.mont_mul", "limbs.field_scan", "limbs.pow_table", "kernels.ntt_sub", "msm_fixed.build_tables",
                "srs.powers_of_tau"):
        assert large_counts[key] > 0, f"{key} did not launch on the 2^20 path"
    card_bytes = prover_kernels._memory_bytes(str(dev))
    budgets = (prover_kernels.R3_CONSTS_SHARE * card_bytes, prover_kernels.R3_ROWCACHE_SHARE * card_bytes)
    assert 9 * m * FR_BYTES <= budgets[1] and 4 * m * FR_BYTES <= budgets[0], (
        f"round 3's caches do not fit their shares of this card's {card_bytes} bytes at 2^20 gates")
    assert (m, str(dev)) in prover_kernels._R3_CONSTS, "round 3's constants are not cached within their budget"
    assert program.common_preprocessed_input().coset_rows is not None, (
        "within their budget the nine coset rows stay on the proving key at 2^20")
    # one evaluation and one combination a prove
    assert (default_chunks["eval"] > 1, default_chunks["combine"] > 1) == (
        n >= dpoly.EVAL_CHUNK, n >= prover_kernels.COMBINE_CHUNK), (
        f"rounds 4 and 5 chunked against their widths: {default_chunks}")
    print(f"  warm prove at the default widths ({dpoly.EVAL_CHUNK}, {prover_kernels.COMBINE_CHUNK}): "
          f"{default_chunks['eval']} evaluation chunks, {default_chunks['combine']} combine chunks; round 3's "
          f"constants and coset rows cached (budgets {budgets[0] / gib:.3f} and {budgets[1] / gib:.3f} GiB of the "
          f"card's {card_bytes / gib:.3f})", flush=True)

    # -- the same blinding on the variable-base paths, and with the governors
    # forced, round 3's caches dropped first (the forced prove builds its
    # tables and rows and frees them at round 3's end; nothing of phase 11
    # reads the caches after it)
    prev = config.get_config()
    governors = (dpoly.EVAL_CHUNK, prover_kernels.COMBINE_CHUNK, prover_kernels.R3_CONSTS_SHARE,
                 prover_kernels.R3_ROWCACHE_SHARE)
    pk = program.common_preprocessed_input()
    try:
        for label, cfg in (
            ("pippenger", config.Config(commit_fixed_base=False, msm_algorithm="pippenger")),
            ("bitserial", config.Config(commit_fixed_base=False, msm_algorithm="bitserial")),
            ("governors forced", config.Config()),
        ):
            config.set_config(cfg)
            forced = label == "governors forced"
            if forced:
                dpoly.EVAL_CHUNK = prover_kernels.COMBINE_CHUNK = min(1 << 17, n >> 3)
                prover_kernels.R3_CONSTS_SHARE = prover_kernels.R3_ROWCACHE_SHARE = 0
                prover_kernels._R3_CONSTS.clear()
                pk.coset_rows = None
                torch.cuda.empty_cache()
                chunks0 = chunk_counts()
            zero_counts(counters)
            torch.cuda.reset_peak_memory_stats(dev)
            prover = Prover(setup, program, engine)
            run_peaks = round_peaks(prover, dev)
            get_metrics().reset()
            t = time.perf_counter()
            proof = prover.prove(witness, blinding=blinding)
            torch.cuda.synchronize()
            phase(f"2^{LARGE_LOG2}: {label} prove", t, f"spans: {get_metrics().report()}")
            c = counts(counters)
            if forced:
                seen = chunks_since(chunks0)
                assert prover_kernels._R3_CONSTS == {} and pk.coset_rows is None, (
                    "round 3's constants or coset rows were cached at a budget of 0")
                print(f"  governors forced: {seen['eval']} evaluation chunks, {seen['combine']} combine "
                      f"chunks; device memory after each round, GiB: "
                      + ", ".join(f"{k} {v / gib:.3f}" for k, v in run_peaks.items())
                      + f"; allocated after the prove {torch.cuda.memory_allocated(dev) / gib:.3f} GiB (after the "
                      f"default warm prove {resident_warm / gib:.3f})", flush=True)
                assert seen["eval"] > default_chunks["eval"] and seen["combine"] > default_chunks["combine"], (
                    "the forced widths cut rounds 4 and 5 finer")
            else:
                print(f"  {label}: bpt_msm_pippenger {c['msm_pippenger.msm_pippenger']}, msm_partials "
                      f"{c['msm.msm_partials']}, g1_padd {c['g1_vec.padd']}, g1_pdouble {c['g1_vec.pdouble']}, "
                      f"Horner {c['msm_fixed.msm_fixed_horner']} launches", flush=True)
                assert c["msm_fixed.msm_fixed_horner"] == 0 and c["g1_vec.padd"] == 0 and c["g1_vec.pdouble"] == 0
                assert c["msm_pippenger.msm_pippenger"] == (9 if label == "pippenger" else 0)
                assert c["msm.msm_partials"] == (9 if label == "bitserial" else 0)
            assert proof.to_bytes() == proofs["warm"], f"2^20 {label} prove: not the fixed-base proof bytes"
    finally:
        config.set_config(prev)
        (dpoly.EVAL_CHUNK, prover_kernels.COMBINE_CHUNK, prover_kernels.R3_CONSTS_SHARE,
         prover_kernels.R3_ROWCACHE_SHARE) = governors
    print("  2^20 proof bytes equal: fixed-base == Pippenger == bit-serial == governors forced", flush=True)

    # -- the kernels at the 2^20 path's shapes against their plain versions
    FIELD_CU, PALLAS = "baby_plonk_tpu_torch/csrc/field.cu", "baby_plonk_tpu/ops/pallas_kernels.py"
    torch.cuda.empty_cache()
    # the 2^22 transform: through the composed passes (2048 x 2048 > SUB_MAX_M)
    log2m = LARGE_LOG2 + 2
    past_sub = ntt.split(m)[1] > kernels.SUB_MAX_M  # 2^22 = 2048 x 2048
    x = random_field(rng, FR, (1, m), dev)
    errs = []
    for inverse in (False, True):
        sub0, comp0 = kernels.ntt_sub.launches, kernels.ntt_sub_4step.composed
        got = ntt.ntt_device(x, inverse)
        sub_n, comp_n = kernels.ntt_sub.launches - sub0, kernels.ntt_sub_4step.composed - comp0
        assert (sub_n, comp_n) == ((4, 1) if past_sub else (2, 0)), (
            f"a 2^{log2m} transform: {sub_n} sub-NTT launches, {comp_n} composed calls")
        want, plain_ms = once_ms(lambda: ntt.ntt_device(x, inverse, plain=True))
        err = max_abs_err(got, want)
        assert err == 0, f"ntt_device at 2^{log2m} (inverse={inverse}) differs from its plain version"
        errs.append(err)
        del got, want
        print(f"  ntt_device (16, 1, 2^{log2m}) {'inverse' if inverse else 'forward'}: exact, {sub_n} sub-NTT "
              f"launches, {comp_n} composed call; plain {plain_ms:.1f} ms", flush=True)
        if not inverse:
            fwd_plain_ms = plain_ms
    x5 = random_field(rng, FR, (5, m), dev)
    ms5 = cuda_ms(lambda: ntt.ntt_device(x5), 3)
    del x5
    record_row(results, f"ntt_sub_4step (16, 1, 2^{log2m}, 1){', composed' if past_sub else ''}",
               "baby_plonk_tpu_torch/csrc/ntt.cu (4 launches, baby_plonk_tpu_torch/ops/kernels.py::"
               "_four_step_composed)", f"{PALLAS}:402", "kernels.ntt_sub_4step",
               max(errs), (cuda_ms(lambda: ntt.ntt_device(x), 5), host_us(lambda: ntt.ntt_device(x), 3)), fwd_plain_ms,
               FR_BYTES * 3 * m, FR_MUL * ((m // 2) * log2m + m), run="2^20",
               shape=f"(16, 1, 2^{log2m}, 1) forward", ms_k5=ms5,
               bound_ms_k5=bound(FR_BYTES * 11 * m, FR_MUL * 5 * ((m // 2) * log2m + m))[0])
    del x
    # round 3's combination at 2^22 lanes; the plain version in slices of 2^18
    # lanes, z(w x) handed to each as a rolled row
    live, fixed = random_field(rng, FR, (5, m), dev), random_field(rng, FR, (9, m), dev)
    zh_inv, dpow = random_field(rng, FR, (m,), dev), random_field(rng, FR, (m,), dev)
    sc = random_field(rng, FR, (6,), dev)
    got = prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4)
    zw = torch.roll(live[:, 3], -4, dims=-1)
    err, plain_ms, step = 0, 0.0, min(1 << 18, m)
    for lo in range(0, m, step):
        part = slice(lo, lo + step)
        want, ms = once_ms(lambda: prover_kernels.round3_combine(
            live[..., part], fixed[..., part], zh_inv[:, part], dpow[:, part], sc, 0, zw=zw[:, part], plain=True))
        err, plain_ms = max(err, max_abs_err(got[:, part], want)), plain_ms + ms
    record_row(results, f"round3_combine (2^{log2m} lanes)", FIELD_CU, "baby_plonk_tpu/ops/prover_kernels.py:75",
               "prover_kernels.round3_combine", err,
               (cuda_ms(lambda: prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4), 5),
                host_us(lambda: prover_kernels.round3_combine(live, fixed, zh_inv, dpow, sc, 4), 3)), plain_ms,
               FR_BYTES * (17 * m + 6), 19 * FR_MUL * m, run="2^20", plain_shape=f"{m // step} slices of {step} lanes")
    del live, fixed, zh_inv, dpow, zw, got
    # the Horner kernel over the SRS's groups (131,073 at 2^20), 3 sets of
    # n + 2 scalars (round 1's commit), at the commit's W and K; the plain
    # version on the first 16 slices of the first and of the last whole
    # chunk (their groups gathered into a chunk of their own, which slices
    # them alike) and on the rest
    n_sc = n + 2
    scp = torch.zeros((16, 3, 8 * G), dtype=torch.int32, device=dev)
    scp[:, :, :n_sc] = random_field(rng, FR, (3, n_sc), dev)
    W = msm_fixed.windows_for(3 * G, dev)
    K = msm_fixed.groups_per_lane(3, G, dev)
    part = msm_fixed.msm_fixed_horner(packed, scp, W, K, gc)
    slots, M = msm_fixed.lane_slots(G, K, gc)[0], -(-gc // K)
    a = min(16, gc - (K - 1) * M)  # slices of K groups at the start of a chunk
    pieces = [(torch.tensor([c * gc + s + k * M for k in range(K) for s in range(a)], device=dev), c * slots, a)
              for c in (0, full - 1)]
    if G > full * gc:
        pieces.append((torch.arange(full * gc, G, device=dev), full * slots, -(-(G - full * gc) // K)))
    err, horner_plain_ms = 0, 0.0
    for groups, first, k in pieces:
        sub = scp.reshape(16, 3, G, 8)[:, :, groups].reshape(16, 3, -1)
        want, ms = once_ms(lambda: msm_fixed.msm_fixed_plain(packed[groups], sub, W, K, groups.numel()))
        err = max(err, max_abs_err(tuple(c[..., first : first + k] for c in part), tuple(c[..., :k] for c in want)))
        horner_plain_ms += ms
    record_row(results, f"msm_fixed_horner ({G:,} groups)", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
               f"{PALLAS}:242", "msm_fixed.msm_fixed_horner", err,
               timed_events(lambda: msm_fixed.msm_fixed_horner(packed, scp, W, K, gc), 3), horner_plain_ms,
               *horner_work(scp, G, W, K, gc), run="2^20",
               shape=f"3 x (2^{LARGE_LOG2} + 2) scalars, {G} groups, W = {W}, K = {K}", windows=W, lane_groups=K,
               commit_ms=cuda_ms(lambda: tabs.msm_many([scp[:, i, :n_sc] for i in range(3)]), 3),
               plain_shape=f"{a} slices of the first and the last whole chunk and the rest, 3 sets")
    # the group tree over the commit's whole chunks of slots (64 at 2^20)
    whole = tuple(c[..., : full * slots].reshape(24, 3, W, full, slots) for c in part)
    want, tree_plain_ms = once_ms(lambda: g1_vec.tree_reduce_plain(whole))
    one_a, one_b = (tuple(c[:, 0, 0, i].contiguous() for c in part) for i in (0, 1))
    add_ms = device_ms(lambda: g1_vec.padd(one_a, one_b), 100)  # one lane: the depth floor's unit
    levels = slots.bit_length() - 1
    nbytes, mads = tree_work(slots, 3 * W * full)
    ms = device_ms(lambda: g1_vec.tree_reduce(whole), 10)
    record_row(results, f"g1_tree (24, 3, {W}, {full}, {slots})", "baby_plonk_tpu_torch/csrc/g1.cu",
               "baby_plonk_tpu/ops/g1_vec.py:298", "g1_vec.tree_reduce", max_abs_err(g1_vec.tree_reduce(whole), want),
               (ms, host_us(lambda: g1_vec.tree_reduce(whole), 10)), tree_plain_ms, nbytes, mads, run="2^20",
               shape=str(tuple(whole[0].shape)), levels=levels, depth_floor_ms=levels * add_ms, add_ms=add_ms,
               share_of_floor=max(levels * add_ms, bound(nbytes, mads)[0]) / ms,
               plan=g1_vec.tree_plan(slots, 3 * W * full, torch.cuda.get_device_properties(dev).multi_processor_count))
    del part, whole, want, scp
    # the table build over the SRS's groups; the plain version on the first
    # 1024 groups and the last one (copies of point 0 pad it)
    pts = srs.setup_points(setup, dev)
    pad = 8 * G - (n + 6)
    k = min(1024, G - 1)
    last = tuple(torch.cat([c[:, 8 * (G - 1):], c[:, :1].expand(24, pad)], dim=-1) for c in pts)
    firsts = tuple(c[:, : 8 * k] for c in pts)
    want, tables_plain_ms = once_ms(lambda: msm_fixed.build_tables_plain(
        *(torch.cat([a, b], dim=-1) for a, b in zip(firsts, last))))
    err = max_abs_err(torch.cat([packed[:k], packed[-1:]]), want)
    padded = tuple(torch.cat([c, c[:, :1].expand(24, pad)], dim=-1) for c in pts)
    del want
    torch.cuda.empty_cache()
    record_row(results, f"msm_build_tables ({G:,} groups)", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
               "baby_plonk_tpu/ops/msm_fixed.py:83", "msm_fixed.build_tables", err,
               timed_events(lambda: msm_fixed.build_tables(*padded), 2), tables_plain_ms, *tables_work(G), run="2^20",
               shape=f"the 2^{LARGE_LOG2} + 6 SRS, {G} groups", plain_shape=f"the first {k} groups and the last one")
    del padded
    # powers of tau over the SRS's 2^20 + 6 lanes; the plain version on the
    # first and last 2^12 lanes, over the table of multiples phase 3 held
    base = srs.generator_base(dev)
    sc = srs.tau_scalars(n + 6, TAU, dev)
    got = srs.powers_of_tau(sc, base)
    k = min(1 << 12, (n + 6) // 2)
    ends = [slice(0, k), slice(n + 6 - k, n + 6)]
    sub = torch.cat([sc[:, s] for s in ends], dim=-1)
    want, pot_plain_ms = once_ms(lambda: srs.powers_of_tau_plain(sub, base, srs.base_table(base)))
    err = max(max_abs_err(tuple(torch.cat([c[:, s] for s in ends], dim=-1) for c in got), want),
              max_abs_err(got, pts))
    record_row(results, f"powers_of_tau (2^{LARGE_LOG2} + 6 lanes)", "baby_plonk_tpu_torch/csrc/srs.cu",
               "baby_plonk_tpu/ops/srs.py:24", "srs.powers_of_tau", err,
               timed_events(lambda: srs.powers_of_tau(sc, base), 3), pot_plain_ms, *powers_of_tau_work(sc),
               run="2^20", shape=f"2^{LARGE_LOG2} + 6 lanes, the table kept",
               plain_shape=f"the first and last {k} lanes")
    del got, want, sc
    print(f"  device memory: {resident / gib:.3f} GiB allocated before phase 11, "
          f"{torch.cuda.memory_allocated(dev) / gib:.3f} GiB at its end", flush=True)
    return large_counts, (seconds["cold"], seconds["warm"]), verify_s


def plan_times(dev):
    """Where a transform's plan time goes, in one process that has run no
    transform yet: at 2^16 and then at 2^20 gates, each size of the prove (n
    and 4 n) and direction, the first call of ``ntt_device`` split into the
    plan (``ntt._plan4``): its cross table built in Python (the plan's time
    less its ``pack_mont``) and ``pack_mont`` of it (the host codec, the
    upload and ``to_mont``); the sub-NTT twiddle tables
    (``ntt.stage_twiddles``, which builds and packs ``sub_twiddles``); and
    the sub-NTT kernel's launches (the first of the process also opts in to
    the kernel's shared memory and loads its module); beside them the second
    call, its launches, and the rest of the first call."""
    import torch

    from baby_plonk_tpu_torch.ops import kernels, limbs, ntt

    spent = {}

    def timer(key, fn):
        def timed_fn(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
            return out
        return timed_fn

    real = (ntt._plan4, ntt.stage_twiddles, kernels.launch)
    real_pack = limbs.FR.pack_mont
    timed_pack = timer("pack_mont", real_pack)
    timed_launch = timer("sub-NTT launches", real[2])
    ntt._plan4 = timer("plan", real[0])
    ntt.stage_twiddles = timer("twiddle tables", real[1])
    # a twiddle table (at most 512 entries) is packed inside stage_twiddles
    limbs.FR.pack_mont = lambda xs, device: (timed_pack if len(xs) > 512 else real_pack)(xs, device)
    kernels.launch = lambda name, *a: (timed_launch if name == "bpt_ntt_sub" else real[2])(name, *a)
    out = []
    try:
        for log2 in (16, LARGE_LOG2):
            for log2n in (log2, log2 + 2):
                x = torch.zeros((16, 1, 1 << log2n), dtype=torch.int32, device=dev)
                for inverse in (False, True):
                    calls, pieces, built = [], [], []
                    for _ in range(2):
                        spent.clear()
                        misses = real[0].cache_info().misses
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        ntt.ntt_device(x, inverse)
                        torch.cuda.synchronize()
                        calls.append(time.perf_counter() - t)
                        pieces.append(dict(spent))
                        built.append(real[0].cache_info().misses - misses)
                    first = pieces[0]
                    # a wrapped piece that no call reached would read as 0 s:
                    # the split holds only while each is hit where expected
                    missing = {"plan", "pack_mont", "sub-NTT launches"} - first.keys()
                    assert not missing, f"plan 2^{log2n}: the first call never reached {sorted(missing)}"
                    assert built[0] > 0 and built[1] == 0 and "sub-NTT launches" in pieces[1], (
                        f"plan 2^{log2n}: plans built by the first and second call {built}, or the second "
                        "launched no sub-NTT")
                    cross = first.pop("plan") - first["pack_mont"]
                    assert cross > 0, f"plan 2^{log2n}: the plan took less than its pack_mont"
                    row = {"prove": f"2^{log2}", "size": f"2^{log2n}", "inverse": inverse, "first_s": calls[0],
                           "second_s": calls[1], "plan_s": calls[0] - calls[1], "cross table (Python)": cross,
                           **first, "rest_s": calls[0] - cross - sum(first.values()),
                           "second_launches_s": pieces[1]["sub-NTT launches"]}
                    out.append(row)
                    print(f"  plan 2^{log2n} {'inverse' if inverse else 'forward'} (prove 2^{log2}), s: "
                          + ", ".join(f"{k} {v:.4f}" for k, v in row.items() if isinstance(v, float)), flush=True)
    finally:
        ntt._plan4, ntt.stage_twiddles, kernels.launch = real
        del limbs.FR.pack_mont
    print(json.dumps({"plan_times": out}), flush=True)


#: every key of the bench's line
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "roofline_pct", "ntt_coeffs_per_s", "ntt_log2",
              "prove_warm_s", "prove_log2", "verify_s", "verifier_preprocess_s", "msm_log2", "prove_warm_range_s",
              "prove_cold_s", "plan_s", "tables_build_s", "srs_device_s", "srs_load_s", "srs_bytes", "round_ms",
              "peak_mem_bytes", "device_busy_share", "build_s", "device", "msm_variable_points_per_s")


def bench_child(cache_dir):
    """Phase 8: ``python -m baby_plonk_tpu_torch bench`` in a child process
    at small sizes; its last stdout line parses as JSON with every key and
    positive rates."""
    env = dict(os.environ, BPT_BENCH_MSM_LOG2="12", BPT_BENCH_NTT_LOG2="16", BPT_BENCH_HOST_LOG2="8",
               BPT_BENCH_PROVE_LOG2="12", BPT_BENCH_BITSERIAL="1", BPT_SRS_CACHE=cache_dir,
               PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-m", "baby_plonk_tpu_torch", "bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    for line in res.stderr.splitlines():
        print(f"  bench: {line}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"the bench exited with {res.returncode}")
    line = json.loads(res.stdout.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    assert not missing, f"the bench's line lacks {missing}"
    for k in ("value", "vs_baseline", "roofline_pct", "ntt_coeffs_per_s", "msm_variable_points_per_s"):
        assert line[k] > 0, f"bench: {k} = {line[k]}"
    assert line["metric"] == "msm_g1_points_per_s" and line["msm_log2"] == 12 and line["prove_log2"] == 12
    print(f"  bench line: {json.dumps(line)}", flush=True)


def main():
    t_all = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "baby_plonk_tpu_torch")):
        sys.exit("chip_smoke: the baby_plonk_tpu_torch package is not beside this script")
    sys.path.insert(0, ROOT)
    import torch

    # 1. device
    t = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    phase("1 device", t)

    # 2. build
    from baby_plonk_tpu_torch import native
    from baby_plonk_tpu_torch.ops import kernels

    t = time.perf_counter()
    kernels.library()
    for source in ("field.cu", "ntt.cu", "g1.cu", "msm.cu", "msm_fixed.cu", "srs.cu", "pippenger.cu"):
        for line in kernels.resource_usage(source).splitlines():
            if "Compiling entry" in line or "stack frame" in line or "Used" in line:
                print(f"  ptxas, {source}: {line.strip()}", flush=True)
    print(f"  native Keccak (transcript hashing) loaded: {native.available()}", flush=True)
    print(f"  native witness reader (round 1) loaded: {native.witness_reader() is not None}", flush=True)
    phase("2 build", t)

    if "--msm-times" in sys.argv:
        msm_times(dev)
        print(f"card: {card}", flush=True)
        return
    if "--setup-times" in sys.argv:
        setup_times(dev)
        print(f"card: {card}", flush=True)
        return
    if "--prove-profile" in sys.argv:
        prove_profile(dev)
        print(f"card: {card}", flush=True)
        return
    if "--plan-times" in sys.argv:
        plan_times(dev)
        print(f"card: {card}", flush=True)
        return
    if "--large" in sys.argv:
        t = time.perf_counter()
        results = []
        large_path(dev, kernel_counters(), results)
        phase("11 2^20 gates", t)
        print(json.dumps({"kernels": results}), flush=True)
        print(f"card: {card}", flush=True)
        return

    # 3. kernels
    t = time.perf_counter()
    results = []
    check_kernels(dev, results)
    phase("3 kernels", t)
    if "--kernels" in sys.argv:
        print(json.dumps({"kernels": results}), flush=True)
        return

    # 4. main path
    counters = kernel_counters()
    #: wrappers with no launch on the main path: the bit-serial MSM, the
    #: mesh's form of round 3, the subtraction (the same kernel as the
    #: addition), which the fused round-3 expression took off every prove,
    #: the elementwise point addition, which no prove runs, and the Pippenger
    #: MSM (phase 6)
    off_main = ("msm.msm_partials", "prover_kernels.round3_combine (zw)", "limbs.sub_mod", "g1_vec.padd",
                "msm_pippenger.msm_pippenger")
    t = time.perf_counter()
    run_counts, warm_counts, circuit, single_s = main_path(dev, 1 << 16, counters)
    print(f"  launches, whole run: {json.dumps(run_counts)}", flush=True)
    print(f"  launches, warm prove: {json.dumps(warm_counts)}", flush=True)
    for key in ("limbs.mont_mul", "limbs.mont_pow_fixed", "limbs.field_scan", "limbs.pow_table",
                "prover_kernels.round3_combine", "prover_kernels.grand_product_fg",
                "kernels.ntt_sub", "kernels.ntt_sub_4step", "msm_fixed.msm_fixed_horner"):
        assert warm_counts[key] > 0, f"{key} did not launch in the warm prove"
    for c in (warm_counts, run_counts):
        assert c["kernels.ntt_sub"] == 2 * c["kernels.ntt_sub_4step"], (
            "every transform is two launches of the sub-NTT kernel")
    assert warm_counts["limbs.mont_mul"] < 220, "a warm prove launches the field product fewer than 220 times"
    assert warm_counts["prover_kernels.round3_combine"] == warm_counts["prover_kernels.grand_product_fg"] == 1
    assert warm_counts["msm_fixed.msm_fixed_horner"] == 4, "a warm prove is 4 commit rounds, one Horner launch each"
    # a commit's group tree: its whole chunks, its rest's group, the chunk combine
    assert warm_counts["g1_vec.tree_reduce"] == 3 * 4, "a warm prove's 4 commits are 3 tree launches each"
    assert warm_counts["g1_vec.padd"] == 0, "the elementwise addition launched in the fixed-base prove"
    for key, count in run_counts.items():
        assert (count > 0) != (key in off_main), f"{key}: {count} launches on the main path"
    phase("4 main path", t)

    # 5. cross-engine
    t = time.perf_counter()
    cross_engine(dev)
    phase("5 cross-engine 2^8 == host engine bytes", t)

    # 6. variable-base path
    t = time.perf_counter()
    *runs, fixed_proof = variable_base_path(dev, counters, circuit)
    vb_counts = dict(zip(("bitserial", "pippenger"), runs))
    for label, c in vb_counts.items():
        print(f"  launches, {label} prove: {json.dumps(c)}", flush=True)
    phase("6 variable-base path", t)

    # 7. setup cache and 8. bench, both on a fresh cache directory
    cache_dir = tempfile.mkdtemp(prefix="bpt_srs_cache_")
    try:
        t = time.perf_counter()
        setup_cache(dev, circuit, fixed_proof, cache_dir)
        phase("7 setup cache", t)
        t = time.perf_counter()
        bench_child(cache_dir)
        phase("8 bench", t)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)

    # 9. the prover sharded over a mesh
    t = time.perf_counter()
    *mesh_runs, mesh_s, physical = mesh_path(dev, counters, circuit, fixed_proof)
    mesh_counts = dict(zip(("fixed", "bitserial"), mesh_runs))
    phase("9 mesh", t)

    # 10. the prover over a mesh of two processes
    t = time.perf_counter()
    mp = mp_path(dev, circuit, fixed_proof)
    runs = mp["gloo"][0]["runs"]
    mp_counts = {"bitserial": runs["bitserial"]["launches"],
                 "fixed": {k: v + runs["fixed warm"]["launches"][k] for k, v in runs["fixed cold"]["launches"].items()}}
    phase("10 multi-process mesh", t)

    # 11. the reference's 2^20-gate configuration
    t = time.perf_counter()
    large_counts, large_s, large_verify_s = large_path(dev, counters, results)
    phase("11 2^20 gates", t)

    for banned in ("jax", "jaxlib", "baby_plonk_tpu"):
        assert not any(m == banned or m.startswith(banned + ".") for m in sys.modules), (
            f"{banned} was imported")
    for r in results:
        key, run = r.pop("wrapper"), r.pop("run")
        r["path"] = {None: "main", "off": "off the main path", "mesh": "mesh (phase 9's fixed-base run)",
                     "2^20": "2^20 gates (phase 11)"}.get(run, f"variable-base ({run})")
        r["launches"] = (vb_counts[run][key] if run in vb_counts else mesh_counts["fixed"][key] if run == "mesh"
                         else large_counts[key] if run == "2^20" else run_counts[key])
        # the same wrapper on phase 11's 2^20-gate path (set-up, cold and warm prove, verify)
        r["launches_2p20"] = large_counts[key]
        assert (r["launches"] > 0) != (run == "off"), f"{r['name']}: {r['launches']} launches on its path"
        # the same path through MeshEngine (Pippenger stays single-device)
        r["launches_mesh"] = 0 if run == "pippenger" else mesh_counts.get(run, mesh_counts["fixed"])[key]
        # and through MeshEngine over two processes (phase 10, rank 0, gloo)
        r["launches_mp"] = 0 if run == "pippenger" else mp_counts.get(run, mp_counts["fixed"])[key]
    phase("total", t_all)
    print(json.dumps({"kernels": results}), flush=True)
    mp_s = "; ".join(
        f"MeshEngine D = 4 over 2 processes ({backend}) "
        + ", ".join(f"{max(r['runs'][label]['s'] for r in rs):.3f}" for label in ("fixed cold", "fixed warm"))
        for backend, rs in mp.items())
    print(f"card: {card} | prove 2^16 cold, warm s: TorchEngine {single_s[0]:.3f}, {single_s[1]:.3f}; "
          f"MeshEngine D = 4 on {physical} card(s) {mesh_s[0]:.3f}, {mesh_s[1]:.3f}; {mp_s} | prove 2^20 cold, "
          f"warm, verify s: {large_s[0]:.3f}, {large_s[1]:.3f}, {large_verify_s:.3f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
