"""MeshEngine (baby_plonk_tpu_torch/parallel/mesh_engine.py) on meshes of
CPU shards: the frozen golden fixtures re-prove through it to their bytes,
its commits agree with the host's where the lengths need padding, its
inverse NTT hands back natural order, and BPT_ENGINE=mesh selects it.
Exact (bytes, points, integers)."""
import json
import os

import pytest
import torch

from baby_plonk_tpu_torch import config
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import engine as engine_mod
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.parallel import mesh as mesh_mod
from baby_plonk_tpu_torch.parallel.mesh import make_mesh
from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
from baby_plonk_tpu_torch.protocol import Program, Proof, Prover, Setup, Verifier
from baby_plonk_tpu_torch.protocol import poly as hostpoly
from baby_plonk_tpu_torch.protocol.poly import Basis, Poly

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("name,D", [("golden_proof.json", 2), ("golden_proof_mul_chain.json", 4),
                                    ("golden_proof_mul_chain.json", 8)])
def test_golden_fixture_reproves(name, D):
    """n = 8 at D = 2 and n = 32 at D = 4: every path shards. n = 32 at
    D = 8: the NTTs of n take the single-device path (n / D < D), round 3
    shards (4n / D = 16) with z(w x) on another shard, the commits shard."""
    with open(os.path.join(_DIR, name)) as f:
        fix = json.load(f)
    n = fix["group_order"]
    setup = Setup.generate_srs(n + 6, tau=fix["tau"], cache=False)
    program = Program.from_strs(fix["circuit"], n)
    engine = MeshEngine(make_mesh(D, device="cpu"))
    assert engine._can_shard(4 * n) and engine._can_shard(n) == (D < 8)
    prover = Prover(setup, program, engine=engine)
    proof = prover.prove(fix["witness"], blinding=fix["blinding"])
    for ch, want in fix["challenges"].items():
        assert getattr(prover.ch, ch) == int(want, 16), ch
    assert proof.to_bytes().hex() == fix["proof_hex"]
    if D == 2:  # the verifier's preprocessing through the mesh too
        proof = Proof.from_bytes(proof.to_bytes())
        assert Verifier(setup, program, proof, engine=engine).verify(fix["public"])
        assert not Verifier(setup, program, proof, engine=engine).verify([fix["public"][0] + 1])


@pytest.mark.parametrize("fixed_base", [True, False])
def test_mesh_commit_matches_host_with_padding(fixed_base, monkeypatch):
    """Commit lengths that fill the SRS, pass n and fall short of it are
    padded with zero scalars against an SRS padded to D 2^k points: the
    commits equal the host's, on both commit paths."""
    monkeypatch.setattr(config, "_config", config.Config(commit_fixed_base=fixed_base))
    setup = Setup.generate_srs(8 + 6, tau=999, cache=False)
    engine = MeshEngine(make_mesh(2, device="cpu"))
    polys = [field_ints(10 + k, fr.Q, k) for k in (14, 13, 5)]
    want = [HostEngine().commit(setup, Poly(list(c), Basis.MONOMIAL)) for c in polys]
    assert engine.commit_many(setup, [engine.poly(c, Basis.MONOMIAL) for c in polys]) == want
    assert setup.mesh_srs[engine.mesh.key]["N"] == 16
    assert (setup.mesh_srs[engine.mesh.key]["tables"] is not None) == fixed_base


def test_mesh_intt_poly_natural_order():
    engine = MeshEngine(make_mesh(4, device="cpu"))
    vals = field_ints(20, fr.Q, 64)
    want = hostpoly.i_ntt(vals)
    assert engine.intt_poly(engine.poly(vals, Basis.LAGRANGE)).values == want
    (got,) = engine.intt_polys([engine.poly(vals, Basis.LAGRANGE)])
    assert got.values == want
    assert engine.intt(vals) == want and engine.ntt(want) == vals
    assert engine.intt(vals[:8]) == hostpoly.i_ntt(vals[:8])  # n / D < D: the single-device path


def test_bpt_engine_mesh_selects_the_mesh_engine(monkeypatch):
    monkeypatch.setenv("BPT_ENGINE", "mesh")
    monkeypatch.setenv("BPT_MESH_DEVICES", "4")
    monkeypatch.setattr(config, "_config", None)
    monkeypatch.setattr(engine_mod, "_default_engine", None)
    if not torch.cuda.is_available():  # no card: the engine raises, no fallback
        with pytest.raises(RuntimeError):
            engine_mod.get_default_engine()
        with pytest.raises(RuntimeError):
            MeshEngine()
        # the same selection with the shards on the CPU
        real = mesh_mod.make_mesh
        monkeypatch.setattr(mesh_mod, "make_mesh", lambda n=None: real(n, device="cpu"))
    engine = engine_mod.get_default_engine()
    assert isinstance(engine, MeshEngine) and engine.D == 4
