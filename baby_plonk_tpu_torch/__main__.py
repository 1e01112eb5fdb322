"""CLI of the port (counterpart of ``baby_plonk_tpu/__main__.py``; parity
with the reference's `cargo verify` alias, .cargo/config:1-3).

  python -m baby_plonk_tpu_torch demo             # reference e2e circuit on the CUDA device
  python -m baby_plonk_tpu_torch demo --cpu       # same on the CPU (the kernels' plain versions)
  python -m baby_plonk_tpu_torch warmup --log2 16 # first-use set-up, one prove and verify at 2^16

Both run on the card unless ``--cpu`` is given; without a card and without
``--cpu`` they raise.
"""
from __future__ import annotations

import argparse
import sys
import time


def _device(cpu: bool) -> str:
    return "cpu" if cpu else "cuda"


def _demo(cpu: bool) -> int:
    from .ops.torch_engine import TorchEngine
    from .protocol import Program, Prover, Setup, Verifier
    from .utils.metrics import get_metrics

    engine = TorchEngine(_device(cpu))

    # the reference's own end-to-end circuit (tests/verify_proof_test.rs:13-50)
    n = 8
    setup = Setup.generate_srs(n + 6, tau=101, cache=False)
    program = Program.from_strs(["e public", "c <== a * b + b", "e <== c * d"], n)
    witness = {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}

    t0 = time.time()
    proof = Prover(setup, program, engine=engine).prove(witness)
    prove_dt = time.time() - t0
    t0 = time.time()
    ok = Verifier(setup, program, proof, engine=engine).verify([80])
    verify_dt = time.time() - t0

    print(f"engine=torch device={engine.device} prove={prove_dt*1e3:.1f}ms "
          f"verify={verify_dt*1e3:.1f}ms ok={ok}")
    print(f"proof: {len(proof.to_bytes())} bytes")
    print(f"metrics: {get_metrics().report()}")
    return 0 if ok else 1


def _warmup(logn: int, tau: int, cpu: bool) -> int:
    """First-use set-up of a proving process at n = 2^logn: build and load
    the CUDA library, compute the device SRS, build the commit tables and
    the proving-key caches through one prove, and verify it. There is no
    compile cache to prime (PyTorch runs eagerly): everything made here
    lives in this process, apart from the built library."""
    from . import circuits
    from .ops import kernels
    from .ops.torch_engine import TorchEngine
    from .protocol import Program, Prover, Verifier, generate_srs_device
    from .utils.metrics import get_metrics

    device = _device(cpu)
    engine = TorchEngine(device)
    n = 1 << logn
    m = get_metrics()
    t_all = time.time()
    if not cpu:
        with m.span("warmup.build"):
            kernels.library()
    constraints, witness, public = circuits.mul_chain(n)
    program = Program.from_strs(constraints, n)
    with m.span("warmup.srs", sync=True):
        setup = generate_srs_device(n + 6, tau, device)
    with m.span("warmup.prove", sync=True):
        proof = Prover(setup, program, engine=engine).prove(witness)
    with m.span("warmup.verify"):
        ok = Verifier(setup, program, proof, engine=engine).verify(public)
    print(
        f"warmup n=2^{logn} device={engine.device}: "
        f"prove={m.durations['warmup.prove']:.3f}s verify={m.durations['warmup.verify']:.3f}s "
        f"ok={ok} total={time.time()-t_all:.1f}s"
    )
    print(f"metrics: {m.report()}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="baby_plonk_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    demo = sub.add_parser("demo", help="prove+verify the reference e2e circuit")
    warm = sub.add_parser("warmup", help="first-use set-up, one prove and verify at 2^N gates")
    warm.add_argument("--log2", type=int, default=16, help="log2 of the gate count")
    warm.add_argument("--tau", type=lambda s: int(s, 0), default=0xDEADBEEF)
    for cmd in (demo, warm):
        cmd.add_argument("--cpu", action="store_true",
                         help="run on the CPU (the kernels' plain PyTorch versions)")
    args = p.parse_args(argv)

    if args.cmd == "demo":
        return _demo(args.cpu)
    return _warmup(args.log2, args.tau, args.cpu)


if __name__ == "__main__":
    sys.exit(main())
