"""Multi-process smoke run of the sharded prover (counterpart of
``scripts/multihost_smoke.py``): the same ``prove_step_sharded`` and
``MeshEngine`` that run on a mesh held by one process run over a
``ProcessMesh`` of P processes, with the collectives (the NTT's
all_to_all, the MSM partials' and the grand product's gathers, round 3's
ppermute) crossing the process boundary.

    python -m baby_plonk_tpu_torch.parallel.multihost_smoke [--cpu] [--backend gloo|nccl]
        [--processes P] [--shards D] [--log2 N] [--step-only] [--timeout S]

The parent spawns P workers (rendezvous: a ``FileStore`` in a fresh
temporary directory), waits for all of them under the timeout, kills the
rest when one fails or the clock runs out, prints every worker's lines and
exits non-zero on any failure. Each worker

  1. joins the group, every collective bounded by the timeout;
  2. runs ``prove_step_sharded`` at n = max(64, D^2) and holds its three
     commitments against the host MSM of the host inverse NTT;
  3. unless ``--step-only``: proves the 2^N-gate multiply chain with
     ``MeshEngine`` and fixed blinding, to the bytes of the single-process
     proof (``TorchEngine`` on its own device), verifies it and rejects a
     wrong public input.

It runs on the card (``nccl`` needs one card a process) unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import os
import sys
import tempfile
import time
from multiprocessing.connection import wait

TAU = 777
BLINDING = list(range(1, 12))


# -- the parent ------------------------------------------------------------------

def spawn(target, args=(), processes: int = 2, backend: str = "gloo", device: str = "cuda",
          timeout: float = 600.0, dir: str | None = None) -> list:
    """Run ``target(device, *args)`` in ``processes`` fresh processes that
    form one ``torch.distributed`` group, and return what each returned (a
    JSON value), in rank order. ``target`` is a module-level function. The
    group meets at a ``FileStore`` in a fresh temporary directory (under
    ``dir`` when given), so no two spawns share a rendezvous. Each
    worker's output goes to a log that is printed here, its lines prefixed
    with the worker. Raises when a worker fails, after killing the others,
    or when ``timeout`` seconds pass, after killing them all; and, before
    starting any, for a placement ``backend`` refuses."""
    from .mesh import placement

    for rank in range(processes):
        placement(device, backend, rank, processes)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bpt_mesh_", dir=dir) as work:
        procs = [ctx.Process(target=_worker, name=f"worker {rank}",
                             args=(rank, processes, backend, device, work, timeout, target, args))
                 for rank in range(processes)]
        for p in procs:
            p.start()
        failure = _wait(procs, time.monotonic() + timeout)
        for rank in range(processes):
            path = os.path.join(work, f"worker{rank}.log")
            if os.path.exists(path):
                with open(path) as f:
                    for line in f.read().splitlines():
                        print(f"[worker {rank}] {line}", flush=True)
        if failure:
            raise RuntimeError(f"multi-process run of {target.__name__}: {failure}")
        results = []
        for rank in range(processes):
            with open(os.path.join(work, f"result{rank}.json")) as f:
                results.append(json.load(f))
        return results


def _wait(procs, deadline: float) -> str | None:
    """Wait for every process until ``deadline``; None when all exited with
    0, else what went wrong. No process is left running."""
    pending = list(procs)
    try:
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                return f"timed out with {', '.join(p.name for p in pending)} still running"
            wait([p.sentinel for p in pending], timeout=left)
            done = [p for p in pending if not p.is_alive()]
            for p in done:
                p.join()
                pending.remove(p)
            failed = [f"{p.name} exited with {p.exitcode}" for p in done if p.exitcode != 0]
            if failed:
                return "; ".join(failed)
        return None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)


def _worker(rank, world, backend, device, work, timeout, target, args):
    with open(os.path.join(work, f"worker{rank}.log"), "w") as log:
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
    # one process a host: the group's connections stay on the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from .mesh import placement

    dev = placement(device, backend, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the plain CPU versions issue many tiny ops: a thread each keeps P workers off each other's cores
        torch.set_num_threads(1)
    # every collective of the group waits at most ``timeout`` seconds
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(work, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        result = target(device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"result{rank}.json"), "w") as f:
        json.dump(result, f)


# -- what a worker checks ----------------------------------------------------------

def step_check(mesh) -> None:
    """``prove_step_sharded`` at n = max(64, D^2) over ``mesh`` against the
    host MSM of the host inverse NTT (every process the same columns)."""
    import numpy as np

    from ..curves import msm_host
    from ..curves.g1 import G1
    from ..fields import fr
    from ..ops import g1_vec
    from ..ops.limbs import FR
    from ..protocol import poly as hostpoly
    from . import prove_step

    n = max(64, mesh.D * mesh.D)
    rng = np.random.default_rng(808)
    cols = [[int(v) % fr.Q for v in rng.integers(0, 1 << 62, size=n)] for _ in range(3)]
    srs = [G1.generator() * pow(TAU, i, fr.Q) for i in range(n)]
    perm = prove_step.cyclic_perm(n, mesh.D)
    px, py, pz = g1_vec.points_to_device([srs[k] for k in perm], mesh.home)
    packed = FR.pack_mont([v for c in cols for v in c], mesh.home).reshape(16, 3, n)
    outs = prove_step.prove_step_sharded(packed, px, py, pz, mesh)
    for i in range(3):
        assert g1_vec.point_from_device(outs[i]) == msm_host.msm(srs, hostpoly.i_ntt(cols[i])), (
            f"prove_step_sharded: column {i} differs from the host MSM of the host iNTT on rank {mesh.rank}")


def circuit(n: int, device, srs_cache: str | None = None, tau: int = TAU):
    """(setup, program, witness, public) of the n-gate multiply chain, the
    SRS of n + 6 powers of ``tau``: the device SRS read from ``srs_cache``
    when given (where it must already be), else computed on the card, or on
    the CPU the host's."""
    import dataclasses

    import torch

    from .. import config
    from ..protocol import Program, Setup, mul_chain

    if srs_cache is not None:
        from ..protocol.setup import device_srs_path

        prev = config.get_config()
        config.set_config(dataclasses.replace(prev, srs_cache_dir=srs_cache))
        try:
            if not os.path.exists(device_srs_path(n + 6, tau)):
                raise FileNotFoundError(f"no SRS of {n + 6} powers of this tau under {srs_cache}")
            setup = Setup.generate_srs_device(n + 6, tau, cache=True, device=device)
        finally:
            config.set_config(prev)
    elif torch.device(device).type == "cpu":
        setup = Setup.generate_srs(n + 6, tau, cache=False)
    else:
        setup = Setup.generate_srs_device(n + 6, tau, cache=False, device=device)
    constraints, witness, public = mul_chain(n)
    return setup, Program.from_strs(constraints, n), witness, public


def single_process_proof(circ, device) -> bytes:
    """The proof bytes of ``TorchEngine`` on ``device``, fixed blinding."""
    from ..ops.torch_engine import TorchEngine
    from ..protocol import Prover

    setup, program, witness, _ = circ
    return Prover(setup, program, TorchEngine(device)).prove(witness, blinding=BLINDING).to_bytes()


def prove_checked(engine, circ, expect: bytes):
    """One prove with fixed blinding, its bytes held against ``expect``.
    Returns the proof, its seconds and the cross-process collectives and
    bytes it took (``ProcessMesh.stats``)."""
    import torch

    from ..protocol import Prover

    setup, program, witness, _ = circ
    before = dict(engine.mesh.stats)
    t = time.perf_counter()
    proof = Prover(setup, program, engine).prove(witness, blinding=BLINDING)
    if engine.mesh.home.type == "cuda":
        torch.cuda.synchronize(engine.mesh.home)
    seconds = time.perf_counter() - t
    assert proof.to_bytes() == expect, f"rank {engine.mesh.rank}: the mesh proof differs from the expected bytes"
    return proof, seconds, {k: v - before[k] for k, v in engine.mesh.stats.items()}


def verify_checked(engine, circ, proof) -> None:
    """The proof verifies; a wrong public input is rejected."""
    from ..protocol import Verifier

    setup, program, _, public = circ
    assert Verifier(setup, program, proof, engine=engine).verify(public), "the mesh proof does not verify"
    wrong = [(public[0] + 1) % (1 << 255)]
    assert not Verifier(setup, program, proof, engine=engine).verify(wrong), "a wrong public input was accepted"


def smoke(device: str, D: int, log2: int, full: bool) -> dict:
    """One worker of the smoke run (module docstring, steps 2 and 3)."""
    from .mesh import make_mesh
    from .mesh_engine import MeshEngine

    mesh = make_mesh(D, device=device)
    step_check(mesh)
    print(f"rank {mesh.rank}: {mesh}: prove_step_sharded over {mesh.P} processes OK", flush=True)
    out = {"rank": mesh.rank, "shards": list(mesh.ids), "device": str(mesh.home), "backend": mesh.backend}
    if full:
        circ = circuit(1 << log2, mesh.home)
        expect = single_process_proof(circ, mesh.home)
        engine = MeshEngine(mesh)
        proof, seconds, stats = prove_checked(engine, circ, expect)
        verify_checked(engine, circ, proof)
        out.update(prove_s=seconds, **stats)
        print(f"rank {mesh.rank}: full 5-round MeshEngine prove at 2^{log2} over {mesh.P} processes OK "
              f"({seconds:.3f} s, {stats['collectives']} cross-process collectives, {stats['bytes']} bytes sent); "
              "verified, wrong public input rejected", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="shards on the CPU (else on the card)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--shards", type=int, default=8, help="D, a multiple of the processes")
    ap.add_argument("--log2", type=int, default=6, help="gates of the full prove: 2^N")
    ap.add_argument("--step-only", action="store_true", help="only prove_step_sharded, no full prove")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole run")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    results = spawn(smoke, (a.shards, a.log2, not a.step_only), a.processes, a.backend, device, a.timeout)
    print(f"multihost smoke: OK ({a.processes} processes, D = {a.shards}, {a.backend} on {device}): "
          f"{json.dumps(results)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
