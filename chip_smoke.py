#!/usr/bin/env python3
"""Smoke run of baby_plonk_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --kernels  # phases 1-3 only (build and kernel checks)

Phases, each printed with its seconds:
  1. device: name and power limit (nvidia-smi); no CUDA device -> exit 1
  2. build: nvcc of the package's CUDA sources into one library
  3. kernels: every kernel of the main path against its plain PyTorch
     version on the card, at main-path shapes, exact equality; the
     fixed-base MSM also against the exact host MSM
  4. main path: device SRS at 2^16 + 6 powers, a 2^16-gate multiply chain,
     a cold and a warm prove, verify, a wrong public input rejected; every
     kernel of the path must have launched
  5. cross-engine: at 2^8 gates with fixed blinding the proof bytes equal
     the host engine's
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

    from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm_fixed, ntt, srs
    from baby_plonk_tpu_torch.reference import msm_host

    rng = np.random.default_rng(SEED)
    FR, FQ = limbs.FR, limbs.FQ

    def record(name, source, replaces, wrapper, err, ms, plain_ms):
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from its plain version (max |err| {err})")
        results.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "wrapper": wrapper, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        print(f"  {name}: exact, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)

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
                   cuda_ms(lambda: limbs._mont_mul_plain(spec, a, b), 5))
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
               cuda_ms(lambda: fn(FR, a, b), 50), cuda_ms(lambda: plain(FR, a, b), 5))
    r2 = limbs._c64(FR, FR.R2, dev)
    one = limbs._c64(FR, 1, dev)
    record("to_mont", "baby_plonk_tpu_torch/csrc/field.cu", "baby_plonk_tpu/ops/limbs.py:824",
           "limbs.to_mont", max_abs_err(limbs.to_mont(FR, a), limbs._mont_mul_plain(FR, a, r2)),
           cuda_ms(lambda: limbs.to_mont(FR, a), 50),
           cuda_ms(lambda: limbs._mont_mul_plain(FR, a, r2), 5))
    record("from_mont", "baby_plonk_tpu_torch/csrc/field.cu", "baby_plonk_tpu/ops/limbs.py:812",
           "limbs.from_mont", max_abs_err(limbs.from_mont(FR, a), limbs._mont_mul_plain(FR, a, one)),
           cuda_ms(lambda: limbs.from_mont(FR, a), 50),
           cuda_ms(lambda: limbs._mont_mul_plain(FR, a, one), 5))
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
                   cuda_ms(lambda: kernels.ntt_sub_plain(x, pw), 2))
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
           cuda_ms(lambda: kernels.ntt_sub_4step(x4, False, plain=True), 1, warm=False))

    # -- powers of tau on 2^10 lanes -------------------------------------------
    base = srs.generator_base(dev)
    sc = srs.tau_scalars(1 << 10, TAU, dev)
    record("powers_of_tau", "baby_plonk_tpu_torch/csrc/srs.cu", "baby_plonk_tpu/ops/srs.py:24",
           "srs.powers_of_tau", max_abs_err(srs.powers_of_tau(sc, base), srs.powers_of_tau_plain(sc, base)),
           cuda_ms(lambda: srs.powers_of_tau(sc, base), 3),
           cuda_ms(lambda: srs.powers_of_tau_plain(sc, base), 1, warm=False))

    # -- fixed-base MSM: one 2^14-point chunk ----------------------------------
    chunk = msm_fixed.CHUNK
    pts = srs.powers_of_tau(srs.tau_scalars(chunk, TAU, dev), base)
    t_k = msm_fixed.build_tables(*pts)
    t_p = msm_fixed.build_tables_plain(*pts)
    record("msm_build_tables", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/msm_fixed.py:83", "msm_fixed.build_tables", max_abs_err(t_k, t_p),
           cuda_ms(lambda: msm_fixed.build_tables(*pts), 2),
           cuda_ms(lambda: msm_fixed.build_tables_plain(*pts), 1, warm=False))
    del t_p
    scal = random_field(rng, FR, (1, chunk), dev)
    tx, ty = t_k
    record("msm_fixed_horner", "baby_plonk_tpu_torch/csrc/msm_fixed.cu",
           "baby_plonk_tpu/ops/pallas_kernels.py:242", "msm_fixed.msm_fixed_horner",
           max_abs_err(msm_fixed.msm_fixed_horner(tx, ty, scal), msm_fixed.msm_fixed_plain(tx, ty, scal)),
           cuda_ms(lambda: msm_fixed.msm_fixed_horner(tx, ty, scal), 5),
           cuda_ms(lambda: msm_fixed.msm_fixed_plain(tx, ty, scal), 1, warm=False))
    parts = msm_fixed.msm_fixed_horner(tx, ty, scal)
    halves = (tuple(c[..., : chunk // 16] for c in parts), tuple(c[..., chunk // 16 :] for c in parts))
    p_k = g1_vec.padd(*halves)
    p_p = g1_vec.padd_plain(*(tuple(c.to(torch.int64) for c in h) for h in halves))
    record("g1_padd", "baby_plonk_tpu_torch/csrc/g1.cu", "baby_plonk_tpu/ops/pallas_kernels.py:139",
           "g1_vec.padd", max_abs_err(p_k, p_p), cuda_ms(lambda: g1_vec.padd(*halves), 20),
           cuda_ms(lambda: g1_vec.padd_plain(*(tuple(c.to(torch.int64) for c in h) for h in halves)), 2))
    # one MSM at 2^10 against the exact host oracle
    m = 1 << 10
    host_pts = g1_vec.points_from_device(tuple(c[:, :m] for c in pts))
    host_sc = limbs.FR.unpack_raw(scal[:, 0, :m])
    tabs = msm_fixed.FixedBaseTables(tuple(c[:, :m] for c in pts), chunk=m)
    got = g1_vec.point_from_device(tabs.msm(scal[:, 0, :m].contiguous()))
    assert got == msm_host.msm(host_pts, host_sc), "fixed-base MSM differs from the host MSM"
    print("  fixed-base MSM 2^10 == curves.msm_host.msm", flush=True)


def main_path(dev, n, counters):
    """Phase 4. Returns the counts of the whole run and of the warm prove."""
    import torch

    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Verifier, mul_chain
    from baby_plonk_tpu_torch.protocol.prover import Prover
    from baby_plonk_tpu_torch.protocol.setup import generate_srs_device

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    for fn in counters.values():
        fn.launches = 0
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
    before = counts()
    t = time.perf_counter()
    proof = Prover(setup, program, engine).prove(witness)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    phase("main: warm prove", t)
    warm_counts = {k: v - before[k] for k, v in counts().items()}
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
    return counts(), warm_counts


def cross_engine(dev):
    """Phase 5: byte-identical proofs against the host engine at 2^8."""
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Setup, mul_chain
    from baby_plonk_tpu_torch.protocol.prover import Prover
    from baby_plonk_tpu_torch.protocol.setup import generate_srs_device
    from baby_plonk_tpu_torch.reference import HostEngine

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
    from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm_fixed, srs

    t = time.perf_counter()
    kernels.library()
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
    }
    t = time.perf_counter()
    run_counts, warm_counts = main_path(dev, 1 << 16, counters)
    print(f"  launches, whole run: {json.dumps(run_counts)}", flush=True)
    print(f"  launches, warm prove: {json.dumps(warm_counts)}", flush=True)
    for key in ("limbs.mont_mul", "kernels.ntt_sub", "kernels.ntt_sub_4step", "msm_fixed.msm_fixed_horner"):
        assert warm_counts[key] > 0, f"{key} did not launch in the warm prove"
    for key, count in run_counts.items():
        assert count > 0, f"{key} did not launch on the main path"
    phase("4 main path", t)

    # 5. cross-engine
    t = time.perf_counter()
    cross_engine(dev)
    phase("5 cross-engine 2^8 == host engine bytes", t)

    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "JAX was imported"
    for r in results:
        r["launches"] = run_counts[r.pop("wrapper")]
    phase("total", t_all)
    print(json.dumps({"kernels": results}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
