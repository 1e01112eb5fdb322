#!/usr/bin/env python3
"""Smoke run of baby_plonk_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and kernel checks)
    python3 chip_smoke.py --msm-times  # phases 1-2, then only the two commit MSMs timed at
                                     # the prove's shapes through entry points that every
                                     # version of the package has (copy the script beside an
                                     # older package to time that one on the same card)

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
     also against the exact host MSM. The two point-MSM kernels are exact at
     one 2^14-point chunk and at a small ragged shape (their plain versions
     take seconds a chunk) and timed at the shapes the proves give them
  4. main path: device SRS at 2^16 + 6 powers, a 2^16-gate multiply chain,
     a cold and a warm prove, verify, a wrong public input rejected; every
     kernel of the path must have launched, the sub-NTT kernel exactly twice
     a transform, the field product fewer than 220 times a warm prove; then
     warm proves under torch.profiler (until two readings agree):
     device time by kernel name and the busy share, no index_select kernel
  5. cross-engine: at 2^8 gates with fixed blinding the proof bytes equal
     the host engine's
  6. variable-base path: the same 2^16 circuit and SRS with
     commit_fixed_base=False, a prove + verify with msm_algorithm
     "bitserial" and one with "pippenger", fixed blinding; proof bytes equal
     to each other and to the fixed-base proof of the same blinding; the
     bit-serial kernel must have launched and the Horner kernel must not
  7. setup cache: on a fresh temporary cache directory,
     Setup.generate_srs_device(2^16 + 6, cache=True) twice (writes, then
     reads); the points read back equal phase 4's, and a prove from them
     gives phase 6's fixed-base proof bytes
  8. bench: python -m baby_plonk_tpu_torch bench in a child process at small
     sizes (MSM, prove 2^12, NTT 2^16, host 2^8, with the bit-serial MSM) on
     the same cache directory; its last line parses with every key
Then one JSON line of kernels, the card line, and the final status line.
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


def check_kernels(dev, results):
    """Phase 3: each kernel wrapper on the card against its plain version."""
    import numpy as np
    import torch

    from baby_plonk_tpu_torch.curves import msm_host
    from baby_plonk_tpu_torch.ops import (g1_vec, kernels, limbs, msm, msm_fixed, msm_pippenger, ntt,
                                          prover_kernels, srs)
    # the peaks and work counts behind every bound (shared with the bench)
    from baby_plonk_tpu_torch.utils.roofline import (ADD_MULS, DOUBLE_MADS, FQ_BYTES, FQ_MUL, FQ_SQR, FR_BYTES,
                                                     FR_MUL, FR_SQR, bound, horner_work)

    rng = np.random.default_rng(SEED)
    FR, FQ = limbs.FR, limbs.FQ

    def record(name, source, replaces, wrapper, err, times, plain_ms, nbytes, mads, run=None, **extra):
        """``times``: (device ms, host us) of one call of the wrapper;
        ``nbytes``: every input read once and every output written once;
        ``mads``: the 32-bit multiply-adds this run's inputs need. No single
        PyTorch call computes any of these modular functions: library_ms is
        null throughout. ``run``: the prove of phase 6 that gives the wrapper
        this shape ("bitserial" or "pippenger"), None for the main path, "off"
        for a wrapper that no prove calls any more.
        ``extra``: further keys of the row."""
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

    FIELD_CU = "baby_plonk_tpu_torch/csrc/field.cu"
    PALLAS = "baby_plonk_tpu/ops/pallas_kernels.py"

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
    del live, fixed, zh_inv, dpow
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

    # -- powers of tau on 2^10 lanes -------------------------------------------
    base = srs.generator_base(dev)
    sc = srs.tau_scalars(1 << 10, TAU, dev)
    record("powers_of_tau", "baby_plonk_tpu_torch/csrc/srs.cu", "baby_plonk_tpu/ops/srs.py:24",
           "srs.powers_of_tau", max_abs_err(srs.powers_of_tau(sc, base), srs.powers_of_tau_plain(sc, base)),
           timed_events(lambda: srs.powers_of_tau(sc, base), 3),
           cuda_ms(lambda: srs.powers_of_tau_plain(sc, base), 1, warm=False),
           (FR_BYTES + 3 * FQ_BYTES) * (1 << 10),
           # per lane 254 doublings and one addition per set bit
           DOUBLE_MADS * 254 * (1 << 10) + FQ_MUL * ADD_MULS * popcount(sc))

    # -- fixed-base MSM: one 2^14-point chunk ----------------------------------
    chunk = msm_fixed.CHUNK
    groups = chunk // msm_fixed.GROUP
    pm2 = FQ.modulus - 2
    inv_mads = (pm2.bit_length() - 1) * FQ_SQR + (bin(pm2).count("1") - 1) * FQ_MUL
    n_srs = (1 << 16) + 6
    srs_pts = srs.powers_of_tau(srs.tau_scalars(n_srs, TAU, dev), base)
    pts = tuple(c[:, :chunk].contiguous() for c in srs_pts)
    t_k = msm_fixed.build_tables(*pts)
    t_p = msm_fixed.build_tables_plain(*pts)
    record("msm_build_tables", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/msm_fixed.py:83", "msm_fixed.build_tables", max_abs_err(t_k, t_p),
           timed_events(lambda: msm_fixed.build_tables(*pts), 2),
           cuda_ms(lambda: msm_fixed.build_tables_plain(*pts), 1, warm=False),
           3 * FQ_BYTES * chunk + FQ_BYTES * 256 * groups,
           # per group 255 additions, and per entry a Fermat inversion (a square
           # per bit of p - 2, a product per set bit) and 2 products
           groups * (FQ_MUL * ADD_MULS * 255 + 256 * (inv_mads + 2 * FQ_MUL)))
    del t_p
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
    del tabs, small_tabs
    tx = t_k
    parts = tuple(c[:, :, 0] for c in msm_fixed.msm_fixed_horner(tx, scal, 1))
    halves = (tuple(c[..., : chunk // 16] for c in parts), tuple(c[..., chunk // 16 :] for c in parts))
    p_k = g1_vec.padd(*halves)
    p_p = g1_vec.padd_plain(*(tuple(c.to(torch.int64) for c in h) for h in halves))
    record("g1_padd", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/pallas_kernels.py:139",
           "g1_vec.padd", max_abs_err(p_k, p_p), timed(lambda: g1_vec.padd(*halves), 20),
           cuda_ms(lambda: g1_vec.padd_plain(*(tuple(c.to(torch.int64) for c in h) for h in halves)), 2),
           9 * FQ_BYTES * (chunk // 16), FQ_MUL * ADD_MULS * (chunk // 16))
    # the other shapes the paths give the addition: the Pippenger prove scans
    # the n + 2 = 65,538 sorted points of a commit and the 2^14 buckets of a
    # window, and every path ends its sums on one lane of shape (24,)
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
               9 * FQ_BYTES * lanes, FQ_MUL * ADD_MULS * lanes, run="pippenger")
    pa = pb = pa64 = pb64 = None
    one_a, one_b = (tuple(c[:, i].contiguous() for c in pts) for i in (1, 2))
    assert one_a[0].shape == (24,)
    assert max_abs_err(g1_vec.padd(one_a, one_b), g1_vec.padd_plain(
        *(tuple(c.to(torch.int64) for c in q) for q in (one_a, one_b)))) == 0, "padd on one lane"
    print("  g1_padd on one lane of shape (24,): exact", flush=True)
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
    del path_pts, srs_pts
    # the doubling's only shape on any path: the Pippenger running total, one
    # point of shape (24,), doubled c times per window
    pt1 = tuple(c[:, 1].contiguous() for c in pts)
    pt64 = tuple(c.to(torch.int64) for c in pt1)
    assert pt1[0].shape == (24,)
    record("g1_pdouble", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/g1_vec.py:165",
           "g1_vec.pdouble", max_abs_err(g1_vec.pdouble(pt1), g1_vec.pdouble_plain(pt64)),
           timed(lambda: g1_vec.pdouble(pt1), 100), cuda_ms(lambda: g1_vec.pdouble_plain(pt64), 5),
           6 * FQ_BYTES, DOUBLE_MADS, run="pippenger")
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
    (bit-serial), with the launches each makes."""
    import numpy as np
    import torch

    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops import g1_vec, limbs, msm, msm_fixed, srs

    rng = np.random.default_rng(SEED)
    n_sc = (1 << 16) + 2
    pts = srs.powers_of_tau(srs.tau_scalars(n_sc + 4, TAU, dev), srs.generator_base(dev))
    tabs = msm_fixed.FixedBaseTables(pts)
    out = {}
    for P in (3, 1):
        sets = [random_field(rng, limbs.FR, (n_sc,), dev) for _ in range(P)]
        tabs.msm_many(sets)
        before = msm_fixed.msm_fixed_horner.launches
        out[f"fixed_base_commit_{P}_sets_ms"] = cuda_ms(lambda: tabs.msm_many(sets), 5)
        out[f"fixed_base_commit_{P}_sets_horner_launches"] = (msm_fixed.msm_fixed_horner.launches - before) // 6
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


def counts(counters):
    return {k: fn.launches for k, fn in counters.items()}


def zero_counts(counters):
    for fn in counters.values():
        fn.launches = 0


def main_path(dev, n, counters):
    """Phase 4. Returns the counts of the whole run and of the warm prove,
    and the setup, program, witness and public input for phase 6."""
    import torch

    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier, mul_chain
    from baby_plonk_tpu_torch.utils.metrics import get_metrics

    zero_counts(counters)
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
    lanes_before = counters["msm_fixed.msm_fixed_horner"].lanes
    t = time.perf_counter()
    proof = Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    phase("main: warm prove", t, f"spans: {get_metrics().report()}")
    # 9 polynomials of 2^16 + 2..6 coefficients = 8193 groups each, times the windows
    print(f"  Horner lanes in the warm prove: {counters['msm_fixed.msm_fixed_horner'].lanes - lanes_before}", flush=True)
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
    return run_counts, warm_counts, (setup, program, witness, public)


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
    print("    torch copy and concatenation kernels: "
          + ", ".join(f"{sum(r[1] for r in rows if word in r[0].lower())} x {word}" for word in ("cat", "memcpy", "copy")),
          flush=True)
    rest = rows[12:]
    print(f"    {sum(r[2] for r in rest):9.3f} ms  {sum(r[1] for r in rest):5d} x  ({len(rest)} other kernels)", flush=True)


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
    assert run_counts["pippenger"]["g1_vec.pdouble"] > 0, "g1_pdouble did not launch in the Pippenger prove"
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


#: every key of the bench's line
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "roofline_pct", "ntt_coeffs_per_s", "ntt_log2",
              "prove_warm_s", "prove_log2", "verify_s", "verifier_preprocess_s", "msm_log2", "prove_warm_range_s",
              "prove_cold_s", "plan_s", "tables_build_s", "srs_device_s", "srs_load_s", "srs_bytes", "round_ms",
              "device_busy_share", "build_s", "device", "msm_variable_points_per_s")


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
    from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm, msm_fixed, prover_kernels, srs

    t = time.perf_counter()
    kernels.library()
    for source in ("field.cu", "ntt.cu", "msm.cu", "msm_fixed.cu"):
        for line in kernels.resource_usage(source).splitlines():
            if "Compiling entry" in line or "stack frame" in line or "Used" in line:
                print(f"  ptxas, {source}: {line.strip()}", flush=True)
    print(f"  native Keccak (transcript hashing) loaded: {native.available()}", flush=True)
    phase("2 build", t)

    if "--msm-times" in sys.argv:
        msm_times(dev)
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
    counters = {
        "limbs.mont_mul": limbs.mont_mul, "limbs.add_mod": limbs.add_mod,
        "limbs.sub_mod": limbs.sub_mod, "limbs.to_mont": limbs.to_mont,
        "limbs.from_mont": limbs.from_mont, "limbs.mont_pow_fixed": limbs.mont_pow_fixed,
        "limbs.field_scan": limbs.field_scan, "limbs.pow_table": limbs.pow_table,
        "prover_kernels.round3_combine": prover_kernels.round3_combine,
        "prover_kernels.grand_product_fg": prover_kernels.grand_product_fg,
        "kernels.ntt_sub": kernels.ntt_sub,
        "kernels.ntt_sub_4step": kernels.ntt_sub_4step, "g1_vec.padd": g1_vec.padd,
        "msm_fixed.build_tables": msm_fixed.build_tables,
        "msm_fixed.msm_fixed_horner": msm_fixed.msm_fixed_horner,
        "msm_fixed.msm_join": msm_fixed.msm_join,
        "srs.powers_of_tau": srs.powers_of_tau,
        "msm.msm_partials": msm.msm_partials, "g1_vec.pdouble": g1_vec.pdouble,
    }
    #: wrappers with no launch on the main path: the variable-base path's
    #: kernels, and the subtraction (the same kernel as the addition), which
    #: the fused round-3 expression took off every prove
    off_main = ("msm.msm_partials", "g1_vec.pdouble", "limbs.sub_mod")
    t = time.perf_counter()
    run_counts, warm_counts, circuit = main_path(dev, 1 << 16, counters)
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

    for banned in ("jax", "jaxlib", "baby_plonk_tpu"):
        assert not any(m == banned or m.startswith(banned + ".") for m in sys.modules), (
            f"{banned} was imported")
    for r in results:
        key, run = r.pop("wrapper"), r.pop("run")
        r["path"] = {None: "main", "off": "off the main path"}.get(run, f"variable-base ({run})")
        r["launches"] = vb_counts[run][key] if run in vb_counts else run_counts[key]
        assert (r["launches"] > 0) != (run == "off"), f"{r['name']}: {r['launches']} launches on its path"
    phase("total", t_all)
    print(json.dumps({"kernels": results}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
