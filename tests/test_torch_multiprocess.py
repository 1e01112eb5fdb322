"""The process mesh (baby_plonk_tpu_torch/parallel/mesh.py::ProcessMesh)
over two gloo processes on the CPU: every collective against the
single-process ``Mesh`` on the same numpy-seeded data, the sharded round-1
step against the host oracles, and ``MeshEngine`` re-proving the frozen
golden fixture (n = 32, frozen from the JAX package) to its bytes. Exact
(integers, points, bytes). Each case is one spawn of
``multihost_smoke.spawn``: a FileStore rendezvous in a fresh directory under
``tmp_path``, one torch thread a worker, every worker killed when one
fails or the spawn's timeout expires. The two slow cases run the
module's command line, the counterparts of tests/test_multihost.py."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from baby_plonk_tpu_torch.parallel import multihost_smoke
from baby_plonk_tpu_torch.parallel.mesh import Mesh, make_mesh, placement

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "golden_proof_mul_chain.json")
#: seconds a spawn may take before its workers are killed
TIMEOUT = 120


def _collectives(device, Ds):
    """Worker: every method of the process mesh against the single-process
    mesh over the same D shards, for each D; returns the checks by name."""
    out = {}
    for D in Ds:
        pm, sm = make_mesh(D, device=device), Mesh(["cpu"] * D)
        rng = np.random.default_rng(100 + D)  # the same data in every process
        x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(3, 2 * D, 4 * D * D)).astype(np.int32))

        def mine(xs):
            return [xs[d] for d in pm.ids]

        def equal(a, b):
            return len(a) == len(b) and all(u.shape == v.shape and torch.equal(u, v) for u, v in zip(a, b))

        ps, ss = pm.shard(x), sm.shard(x)
        checks = {"shard": equal(ps, mine(ss)), "gather": torch.equal(pm.gather(ps), x),
                  "all_gather": equal(pm.all_gather(ps), mine(sm.all_gather(ss)))}
        for split, concat in ((-1, -1), (-2, -2), (-1, -2), (-2, -1)):
            checks[f"all_to_all {split} {concat}"] = equal(pm.all_to_all(ps, split, concat),
                                                         mine(sm.all_to_all(ss, split, concat)))
        for name, source in (("from the other process", lambda d: (d + D // 2) % D),
                             ("from the next shard", lambda d: (d + 1) % D),
                             ("reversed", lambda d: D - 1 - d), ("own shard", lambda d: d)):
            checks[f"ppermute {name}"] = equal(pm.ppermute(ps, source), mine(sm.ppermute(ss, source)))
        rows = [p[:, 1] for p in ps]  # strided views, as round 3 passes them
        checks["ppermute of views"] = equal(pm.ppermute(rows, lambda d: (d + D // 2) % D),
                                            mine(sm.ppermute([s[:, 1] for s in ss], lambda d: (d + D // 2) % D)))
        checks["agree"] = pm.agree([pm.rank, (1 << 255) + pm.rank]) == [0, 1 << 255]
        try:
            make_mesh(D + 1, device=device)
            checks["D + 1 shards raise"] = False
        except ValueError:
            checks["D + 1 shards raise"] = True
        checks["placement"] = (pm.ids == range(pm.rank * D // 2, (pm.rank + 1) * D // 2)
                               and pm.key[:2] == (f"rank {pm.rank} of 2", f"D {D}"))
        out[str(D)] = checks
    return out


def _step(device):
    mesh = make_mesh(8, device=device)
    multihost_smoke.step_check(mesh)
    return mesh.stats


def _golden(device, D):
    """Worker: MeshEngine over the process mesh re-proves the fixture."""
    from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
    from baby_plonk_tpu_torch.protocol import Program, Proof, Prover, Setup, Verifier

    with open(FIXTURE) as f:
        fix = json.load(f)
    n = fix["group_order"]
    setup = Setup.generate_srs(n + 6, tau=fix["tau"], cache=False)
    program = Program.from_strs(fix["circuit"], n)
    engine = MeshEngine(make_mesh(D, device=device))
    prover = Prover(setup, program, engine=engine)
    proof = prover.prove(fix["witness"], blinding=fix["blinding"])
    challenges = {ch: hex(getattr(prover.ch, ch)) for ch in fix["challenges"]}
    proof = Proof.from_bytes(proof.to_bytes())
    verified = Verifier(setup, program, proof, engine=engine).verify(fix["public"])
    out = {"proof_hex": proof.to_bytes().hex(), "challenges": challenges, "verified": verified,
           "stats": engine.mesh.stats}
    if D == 4:  # drawn blinding: one draw for both processes
        out["drawn_hex"] = prover.prove(fix["witness"]).to_bytes().hex()
    return out


def _fail(device):
    """Worker: rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("worker 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))


def _hang(device):
    time.sleep(3600)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return multihost_smoke.spawn(_collectives, ((2, 4),), 2, "gloo", "cpu", TIMEOUT,
                                 dir=tmp_path_factory.mktemp("store"))


@pytest.mark.parametrize("D", [2, 4])
def test_process_mesh_collectives_equal_single_process(collectives, D):
    """shard, gather, all_gather, all_to_all over both axes, ppermute with
    sources on the other process, on the same and on both, agree; exact."""
    for checks in collectives:
        failed = [name for name, ok in checks[str(D)].items() if not ok]
        assert not failed, failed


def test_make_mesh_over_processes_needs_a_multiple(collectives):
    """D + 1 shards over two processes (3 and 5) raise in make_mesh, and the
    process mesh's key names its rank and world size."""
    for checks in collectives:
        for D in ("2", "4"):
            assert checks[D]["D + 1 shards raise"] and checks[D]["placement"]


def test_prove_step_sharded_over_two_processes(tmp_path):
    """n = 64, D = 8: the three commitments equal the host MSM of the host
    inverse NTT (the JAX script's first check); the NTT's all_to_alls and
    the MSM partials cross processes."""
    stats = multihost_smoke.spawn(_step, (), 2, "gloo", "cpu", TIMEOUT, dir=tmp_path)
    assert all(s["collectives"] > 0 and s["bytes"] > 0 for s in stats)


@pytest.mark.parametrize("D", [8, 4])
def test_golden_fixture_over_two_processes(D, tmp_path):
    """D = 8: round 3's z(w x) rows all come from the other process
    (source (d + 4) mod 8); D = 4: they stay on each shard. Both ranks give
    the frozen bytes and challenges, and verify. At D = 4 a prove with
    drawn blinding gives one proof in both ranks (rank 0's draw)."""
    with open(FIXTURE) as f:
        fix = json.load(f)
    results = multihost_smoke.spawn(_golden, (D,), 2, "gloo", "cpu", TIMEOUT, dir=tmp_path)
    for r in results:
        assert r["proof_hex"] == fix["proof_hex"]
        assert r["challenges"] == {ch: hex(int(v, 16)) for ch, v in fix["challenges"].items()}
        assert r["verified"] and r["stats"]["collectives"] > 0
    if D == 4:
        assert results[0]["drawn_hex"] == results[1]["drawn_hex"] != fix["proof_hex"]


def test_placement_refuses_nccl_without_a_card_each(tmp_path):
    """nccl with two ranks on one card, or on the CPU, raises before any
    process starts; gloo shares a card."""
    with pytest.raises(ValueError, match="one process a card"):
        placement("cuda", "nccl", 1, 2, cards=1)
    assert placement("cuda", "nccl", 1, 2, cards=2) == torch.device("cuda", 1)
    assert placement("cuda", "gloo", 1, 2, cards=1) == torch.device("cuda", 0)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multihost_smoke.spawn(_step, (), 2, "nccl", "cpu", TIMEOUT, dir=tmp_path)


def test_failing_worker_fails_the_parent(tmp_path, capsys):
    """Rank 1 raises while rank 0 waits in a collective: the parent raises,
    with no worker left running, long before the group's timeout, and
    prints rank 1's traceback. (Rank 0's collective may fail first, once
    rank 1's connection closes.)"""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="exited with 1"):
        multihost_smoke.spawn(_fail, (), 2, "gloo", "cpu", TIMEOUT, dir=tmp_path)
    assert time.monotonic() - t < TIMEOUT / 2
    assert "[worker 1] RuntimeError: worker 1 fails on purpose" in capsys.readouterr().out


def test_spawn_timeout_kills_the_workers(tmp_path):
    with pytest.raises(RuntimeError, match="timed out"):
        multihost_smoke.spawn(_hang, (), 2, "gloo", "cpu", 4, dir=tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("full", [False, True], ids=["step-only", "full"])
def test_multihost_smoke_command_line(full):
    """``python -m baby_plonk_tpu_torch.parallel.multihost_smoke --cpu`` at
    n = 64, D = 8 over two processes, without and with the full prove."""
    cmd = [sys.executable, "-m", "baby_plonk_tpu_torch.parallel.multihost_smoke", "--cpu",
           "--shards", "8", "--log2", "6", "--timeout", "500"] + ([] if full else ["--step-only"])
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    lines = res.stdout.splitlines()
    for rank in (0, 1):
        assert any(f"rank {rank}:" in line and "prove_step_sharded over 2 processes OK" in line for line in lines)
        assert any(f"rank {rank}: full 5-round" in line for line in lines) == full
    assert lines[-1].startswith("multihost smoke: OK")
