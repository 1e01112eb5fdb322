#!/usr/bin/env python3
"""Smoke run of baby_plonk_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and kernel checks)

Phases, each printed with its seconds:
  1. device: name and power limit (nvidia-smi); no CUDA device -> exit 1
  2. build: nvcc of the package's CUDA sources into one library
  3. kernels: every kernel of the paths below against its plain PyTorch
     version on the card, at the paths' shapes, exact equality (integers: no
     tolerance), timed beside the plain version, with the least time the
     card could take for the same work (bound); the fixed-base, bit-serial
     and Pippenger MSMs also against the exact host MSM
  4. main path: device SRS at 2^16 + 6 powers, a 2^16-gate multiply chain,
     a cold and a warm prove, verify, a wrong public input rejected; every
     kernel of the path must have launched
  5. cross-engine: at 2^8 gates with fixed blinding the proof bytes equal
     the host engine's
  6. variable-base path: the same 2^16 circuit and SRS with
     commit_fixed_base=False, a prove + verify with msm_algorithm
     "bitserial" and one with "pippenger", fixed blinding; proof bytes equal
     to each other and to the fixed-base proof of the same blinding; the
     bit-serial kernel must have launched and the Horner kernel must not
Then one JSON line of kernels, the card line, and the final status line.
Any failure raises: non-zero exit, no status line.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20260101
TAU = 0x5EED_7A0

#: The card's peaks for the bounds (NVIDIA H100 SXM data sheet): HBM3 at
#: 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores = 33.5e12 fused
#: multiply-adds a second on 128 lanes per SM, and the 32-bit integer
#: multiply-add pipe has half those lanes.
MEM_BYTES_PER_S = 3.35e12
INT_MAD_PER_S = 67e12 / 2 / 2
#: 32-bit multiply-adds of one CIOS Montgomery product over N words
#: (csrc/field.cuh::mul): 2 N^2 + N
FR_MUL, FQ_MUL = 2 * 8 * 8 + 8, 2 * 12 * 12 + 12
#: Fq products of the point formulas (csrc/g1.cuh)
ADD_MULS, DOUBLE_MULS, MIXED_MULS = 12, 8, 11
#: bytes of one Fr / Fq element in memory (16-bit limbs in int32)
FR_BYTES, FQ_BYTES = 64, 96


def bound(nbytes, mads):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    32-bit multiply-adds over the integer rate."""
    t_b, t_o = nbytes / MEM_BYTES_PER_S * 1e3, mads / INT_MAD_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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
    from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm, msm_fixed, msm_pippenger, ntt, srs

    rng = np.random.default_rng(SEED)
    FR, FQ = limbs.FR, limbs.FQ

    def record(name, source, replaces, wrapper, err, ms, plain_ms, nbytes, mads, run=None):
        """``nbytes``: every input read once and every output written once;
        ``mads``: the 32-bit multiply-adds this run's inputs need. No single
        PyTorch call computes any of these modular functions: library_ms is
        null throughout. ``run``: the prove of phase 6 that gives the wrapper
        this shape ("bitserial" or "pippenger"), None for the main path."""
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
        bound_ms, bound_by = bound(nbytes, mads)
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "wrapper": wrapper, "run": run, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        print(f"  {name}: exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4g} ms ({bound_by})", flush=True)

    # -- field elementwise (2^16 lanes) --------------------------------------
    n = 1 << 16
    for spec, tag in ((FR, "fr"), (FQ, "fq")):
        a, b = random_field(rng, spec, (n,), dev), random_field(rng, spec, (n,), dev)
        got = limbs.mont_mul(spec, a, b)
        want = limbs._mont_mul_plain(spec, a, b)
        if tag == "fr":
            record("mont_mul", "baby_plonk_tpu_torch/csrc/field.cu",
                   "baby_plonk_tpu/ops/pallas_kernels.py:43", "limbs.mont_mul",
                   max_abs_err(got, want), cuda_ms(lambda: limbs.mont_mul(spec, a, b), 50),
                   cuda_ms(lambda: limbs._mont_mul_plain(spec, a, b), 5),
                   3 * FR_BYTES * n, FR_MUL * n)
        else:
            assert max_abs_err(got, want) == 0, "Fq mont_mul differs from its plain version"
            print("  mont_mul (Fq, 2^16): exact", flush=True)
    a, b = random_field(rng, FR, (n,), dev), random_field(rng, FR, (n,), dev)
    for name, fn, plain, line in (
        ("add_mod", limbs.add_mod, limbs._add_plain, 325),
        ("sub_mod", limbs.sub_mod, limbs._sub_plain, 334),
    ):
        record(name, "baby_plonk_tpu_torch/csrc/field.cu", f"baby_plonk_tpu/ops/limbs.py:{line}",
               f"limbs.{name}", max_abs_err(fn(FR, a, b), plain(FR, a, b)),
               cuda_ms(lambda: fn(FR, a, b), 50), cuda_ms(lambda: plain(FR, a, b), 5),
               3 * FR_BYTES * n, 2 * 8 * n)  # two 8-word carry chains, no products
    r2 = limbs._c64(FR, FR.R2, dev)
    one = limbs._c64(FR, 1, dev)
    record("to_mont", "baby_plonk_tpu_torch/csrc/field.cu", "baby_plonk_tpu/ops/limbs.py:824",
           "limbs.to_mont", max_abs_err(limbs.to_mont(FR, a), limbs._mont_mul_plain(FR, a, r2)),
           cuda_ms(lambda: limbs.to_mont(FR, a), 50),
           cuda_ms(lambda: limbs._mont_mul_plain(FR, a, r2), 5), 2 * FR_BYTES * n, FR_MUL * n)
    record("from_mont", "baby_plonk_tpu_torch/csrc/field.cu", "baby_plonk_tpu/ops/limbs.py:812",
           "limbs.from_mont", max_abs_err(limbs.from_mont(FR, a), limbs._mont_mul_plain(FR, a, one)),
           cuda_ms(lambda: limbs.from_mont(FR, a), 50),
           cuda_ms(lambda: limbs._mont_mul_plain(FR, a, one), 5), 2 * FR_BYTES * n, FR_MUL * n)
    # off the main path, checked all the same
    assert max_abs_err(limbs.neg_mod(FR, a), limbs._neg_plain(FR, a)) == 0, "neg_mod"
    cond = torch.from_numpy(rng.integers(0, 2, size=n).astype(bool)).to(dev)
    assert max_abs_err(limbs.select(cond, a, b), torch.where(cond[None], a, b)) == 0, "select"
    print("  neg_mod, select (off the main path): exact", flush=True)

    # -- sub-NTT (16, 1, 256, 256) and the four-step at the prove's sizes ------
    x = random_field(rng, FR, (1, 256, 256), dev)
    for inverse in (False, True):
        pw = ntt.sub_twiddles(256, inverse, dev)
        got, want = kernels.ntt_sub(x, inverse), kernels.ntt_sub_plain(x, pw)
        err = max_abs_err(got, want)
        if not inverse:
            record("ntt_sub", "baby_plonk_tpu_torch/csrc/ntt.cu",
                   "baby_plonk_tpu/ops/pallas_kernels.py:355", "kernels.ntt_sub", err,
                   cuda_ms(lambda: kernels.ntt_sub(x, False), 20),
                   cuda_ms(lambda: kernels.ntt_sub_plain(x, pw), 2),
                   FR_BYTES * (2 * 256 * 256 + 128),  # elements in and out, twiddles
                   FR_MUL * (256 // 2) * 8 * 256)     # one product per butterfly
        else:
            assert err == 0, "inverse sub-NTT differs from its plain version"
    x8 = random_field(rng, FR, (8, 1 << 16), dev)
    x18 = random_field(rng, FR, (1 << 18,), dev)
    for xx, label in ((x8, "(16, 8, 2^16)"), (x18, "(16, 2^18)")):
        for inverse in (False, True):
            err = max_abs_err(ntt.ntt_device(xx, inverse), ntt.ntt_device(xx, inverse, plain=True))
            assert err == 0, f"ntt_device {label} inverse={inverse} differs"
        print(f"  ntt_device {label}: exact, forward and inverse", flush=True)
    x4 = x8.reshape(16, 8, 1 << 16, 1)
    record("ntt_sub_4step", "baby_plonk_tpu_torch/ops/kernels.py (composition of csrc/ntt.cu and csrc/field.cu)",
           "baby_plonk_tpu/ops/pallas_kernels.py:402", "kernels.ntt_sub_4step",
           max_abs_err(kernels.ntt_sub_4step(x4, False), kernels.ntt_sub_4step(x4, False, plain=True)),
           cuda_ms(lambda: kernels.ntt_sub_4step(x4, False), 10),
           cuda_ms(lambda: kernels.ntt_sub_4step(x4, False, plain=True), 1, warm=False),
           FR_BYTES * (2 * 8 + 1) * (1 << 16),  # 8 polys in and out, the cross-twiddle table
           FR_MUL * 8 * ((1 << 15) * 16 + (1 << 16)))  # butterflies + cross twiddles

    # -- powers of tau on 2^10 lanes -------------------------------------------
    base = srs.generator_base(dev)
    sc = srs.tau_scalars(1 << 10, TAU, dev)
    record("powers_of_tau", "baby_plonk_tpu_torch/csrc/srs.cu", "baby_plonk_tpu/ops/srs.py:24",
           "srs.powers_of_tau", max_abs_err(srs.powers_of_tau(sc, base), srs.powers_of_tau_plain(sc, base)),
           cuda_ms(lambda: srs.powers_of_tau(sc, base), 3),
           cuda_ms(lambda: srs.powers_of_tau_plain(sc, base), 1, warm=False),
           (FR_BYTES + 3 * FQ_BYTES) * (1 << 10),
           # per lane 254 doublings and one addition per set bit
           FQ_MUL * (DOUBLE_MULS * 254 * (1 << 10) + ADD_MULS * popcount(sc)))

    # -- fixed-base MSM: one 2^14-point chunk ----------------------------------
    chunk = msm_fixed.CHUNK
    groups = chunk // msm_fixed.GROUP
    pm2 = FQ.modulus - 2
    inv_muls = pm2.bit_length() + bin(pm2).count("1")
    pts = srs.powers_of_tau(srs.tau_scalars(chunk, TAU, dev), base)
    t_k = msm_fixed.build_tables(*pts)
    t_p = msm_fixed.build_tables_plain(*pts)
    record("msm_build_tables", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/msm_fixed.py:83", "msm_fixed.build_tables", max_abs_err(t_k, t_p),
           cuda_ms(lambda: msm_fixed.build_tables(*pts), 2),
           cuda_ms(lambda: msm_fixed.build_tables_plain(*pts), 1, warm=False),
           3 * FQ_BYTES * chunk + 2 * FQ_BYTES * 256 * groups,
           # per group 255 additions, and per entry a Fermat inversion
           # (one squaring per bit of p - 2, one product per set bit) and 2 products
           FQ_MUL * groups * (ADD_MULS * 255 + 256 * (inv_muls + 2)))
    del t_p
    scal = random_field(rng, FR, (1, chunk), dev)
    tx, ty = t_k
    nonzero_steps = sum(int((msm_fixed._table_index(scal, bit) != 0).sum())
                        for bit in range(msm_fixed.NBITS))
    record("msm_fixed_horner", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/pallas_kernels.py:242", "msm_fixed.msm_fixed_horner",
           max_abs_err(msm_fixed.msm_fixed_horner(tx, ty, scal), msm_fixed.msm_fixed_plain(tx, ty, scal)),
           cuda_ms(lambda: msm_fixed.msm_fixed_horner(tx, ty, scal), 5),
           cuda_ms(lambda: msm_fixed.msm_fixed_plain(tx, ty, scal), 1, warm=False),
           2 * FQ_BYTES * 256 * groups + FR_BYTES * chunk + 3 * FQ_BYTES * groups,
           # per group lane 255 doublings and a mixed addition per step whose index is not 0
           FQ_MUL * (DOUBLE_MULS * 255 * groups + MIXED_MULS * nonzero_steps))
    parts = msm_fixed.msm_fixed_horner(tx, ty, scal)
    halves = (tuple(c[..., : chunk // 16] for c in parts), tuple(c[..., chunk // 16 :] for c in parts))
    p_k = g1_vec.padd(*halves)
    p_p = g1_vec.padd_plain(*(tuple(c.to(torch.int64) for c in h) for h in halves))
    record("g1_padd", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/pallas_kernels.py:139",
           "g1_vec.padd", max_abs_err(p_k, p_p), cuda_ms(lambda: g1_vec.padd(*halves), 20),
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
               cuda_ms(lambda: g1_vec.padd(pa, pb), 20),
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

    # -- variable-base MSM: one 2^14-point chunk ---------------------------------
    sc1 = scal[:, 0].contiguous()
    tiles = chunk // 256
    record("msm_partials", "baby_plonk_tpu_torch/csrc/msm.cu",
           "baby_plonk_tpu/ops/pallas_kernels.py:107", "msm.msm_partials",
           max_abs_err(msm.msm_partials(pts, sc1), msm.msm_partials_plain(pts, sc1)),
           cuda_ms(lambda: msm.msm_partials(pts, sc1), 3),
           cuda_ms(lambda: msm.msm_partials_plain(pts, sc1), 1, warm=False),
           (3 * FQ_BYTES + FR_BYTES) * chunk + 3 * FQ_BYTES * tiles,
           # per lane 254 doublings and one addition per set bit, then the in-tile tree
           FQ_MUL * (DOUBLE_MULS * 254 * chunk + ADD_MULS * (popcount(sc1) + chunk - tiles)),
           run="bitserial")
    # a chunk of zero scalars (4 of the 8 chunks of a padded 2^16-gate commit):
    # the kernel runs the doublings and the tree, and no addition in the bit loop
    zeros = torch.zeros_like(sc1)
    assert max_abs_err(msm.msm_partials(pts, zeros), msm.msm_partials_plain(pts, zeros)) == 0, (
        "msm_partials differs from its plain version on zero scalars")
    print(f"  msm_partials, 2^14-point chunk of zero scalars: exact, kernel "
          f"{cuda_ms(lambda: msm.msm_partials(pts, zeros), 3):.4f} ms", flush=True)
    # the doubling's only shape on any path: the Pippenger running total, one
    # point of shape (24,), doubled c times per window
    pt1 = tuple(c[:, 1].contiguous() for c in pts)
    pt64 = tuple(c.to(torch.int64) for c in pt1)
    assert pt1[0].shape == (24,)
    record("g1_pdouble", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/g1_vec.py:165",
           "g1_vec.pdouble", max_abs_err(g1_vec.pdouble(pt1), g1_vec.pdouble_plain(pt64)),
           cuda_ms(lambda: g1_vec.pdouble(pt1), 100), cuda_ms(lambda: g1_vec.pdouble_plain(pt64), 5),
           6 * FQ_BYTES, FQ_MUL * DOUBLE_MULS, run="pippenger")
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
    from baby_plonk_tpu_torch.protocol import Program, Prover, Verifier, generate_srs_device, mul_chain

    zero_counts(counters)
    t = time.perf_counter()
    setup = generate_srs_device(n + 6, TAU, dev)
    torch.cuda.synchronize()
    phase("main: device SRS 2^16+6", t)
    t = time.perf_counter()
    constraints, witness, public = mul_chain(n)
    program = Program.from_strs(constraints, n)
    phase("main: circuit + program (host)", t)
    engine = TorchEngine(dev)
    t = time.perf_counter()
    Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t
    phase("main: cold prove", t)
    before = counts(counters)
    t = time.perf_counter()
    proof = Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    phase("main: warm prove", t)
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
    return counts(counters), warm_counts, (setup, program, witness, public)


def variable_base_path(dev, counters, circuit):
    """Phase 6. Returns the counts of the bit-serial and the Pippenger run."""
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
    assert run_counts["bitserial"]["msm.msm_partials"] > 0, "msm_partials did not launch in the bit-serial prove"
    assert run_counts["pippenger"]["g1_vec.pdouble"] > 0, "g1_pdouble did not launch in the Pippenger prove"
    assert run_counts["pippenger"]["msm.msm_partials"] == 0, "the bit-serial kernel launched in the Pippenger prove"
    assert proofs["bitserial"] == proofs["pippenger"] == proofs["fixed"], (
        "the three commit configurations give different proof bytes")
    print("  proof bytes equal: fixed-base == bit-serial == Pippenger (624 bytes, fixed blinding)", flush=True)
    return run_counts["bitserial"], run_counts["pippenger"]


def cross_engine(dev):
    """Phase 5: byte-identical proofs against the host engine at 2^8."""
    from baby_plonk_tpu_torch.ops.engine import HostEngine
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, generate_srs_device, mul_chain

    n = 1 << 8
    constraints, witness, _ = mul_chain(n)
    program = Program.from_strs(constraints, n)
    blinding = list(range(1, 12))
    port = Prover(generate_srs_device(n + 6, TAU, dev), program, TorchEngine(dev)).prove(
        witness, blinding=blinding)
    host_setup = Setup.generate_srs(n + 6, TAU, cache=False)
    host = Prover(host_setup, program, engine=HostEngine()).prove(witness, blinding=blinding)
    assert port.to_bytes() == host.to_bytes(), "port and host engine proofs differ"


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
    from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm, msm_fixed, srs

    t = time.perf_counter()
    kernels.library()
    for line in kernels.resource_usage("msm.cu").splitlines():
        if "Compiling entry" in line or "stack frame" in line or "Used" in line:
            print(f"  ptxas, msm.cu: {line.strip()}", flush=True)
    print(f"  native Keccak (transcript hashing) loaded: {native.available()}", flush=True)
    phase("2 build", t)

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
        "limbs.from_mont": limbs.from_mont, "kernels.ntt_sub": kernels.ntt_sub,
        "kernels.ntt_sub_4step": kernels.ntt_sub_4step, "g1_vec.padd": g1_vec.padd,
        "msm_fixed.build_tables": msm_fixed.build_tables,
        "msm_fixed.msm_fixed_horner": msm_fixed.msm_fixed_horner,
        "srs.powers_of_tau": srs.powers_of_tau,
        "msm.msm_partials": msm.msm_partials, "g1_vec.pdouble": g1_vec.pdouble,
    }
    #: kernels of the variable-base path only: no launch on the main path
    variable_only = ("msm.msm_partials", "g1_vec.pdouble")
    t = time.perf_counter()
    run_counts, warm_counts, circuit = main_path(dev, 1 << 16, counters)
    print(f"  launches, whole run: {json.dumps(run_counts)}", flush=True)
    print(f"  launches, warm prove: {json.dumps(warm_counts)}", flush=True)
    for key in ("limbs.mont_mul", "kernels.ntt_sub", "kernels.ntt_sub_4step", "msm_fixed.msm_fixed_horner"):
        assert warm_counts[key] > 0, f"{key} did not launch in the warm prove"
    for key, count in run_counts.items():
        assert (count > 0) != (key in variable_only), f"{key}: {count} launches on the main path"
    phase("4 main path", t)

    # 5. cross-engine
    t = time.perf_counter()
    cross_engine(dev)
    phase("5 cross-engine 2^8 == host engine bytes", t)

    # 6. variable-base path
    t = time.perf_counter()
    vb_counts = dict(zip(("bitserial", "pippenger"), variable_base_path(dev, counters, circuit)))
    for label, c in vb_counts.items():
        print(f"  launches, {label} prove: {json.dumps(c)}", flush=True)
    phase("6 variable-base path", t)

    for banned in ("jax", "jaxlib", "baby_plonk_tpu"):
        assert not any(m == banned or m.startswith(banned + ".") for m in sys.modules), (
            f"{banned} was imported")
    for r in results:
        key, run = r.pop("wrapper"), r.pop("run")
        r["path"] = f"variable-base ({run})" if run else "main"
        r["launches"] = vb_counts[run][key] if run else run_counts[key]
        assert r["launches"] > 0, f"{r['name']} launched no time on its path"
    phase("total", t_all)
    print(json.dumps({"kernels": results}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
