"""The port end to end at n = 8 on the CPU: byte-identical proofs with the
port's exact host engine, the port's verifier engine accepts them and
rejects a wrong public input; every engine has the whole engine contract
(ops/engine.py) and the device engine's round steps equal the host
engine's; plus the engine's guards. Tolerance: exact (integers and
bytes)."""
import pytest
import torch

from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.ops.srs import setup_points
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.parallel.mesh import make_mesh
from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier
from baby_plonk_tpu_torch.protocol.prover import K1, K2
from baby_plonk_tpu_torch.protocol.poly import Basis, Poly

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

CIRCUIT = ["e public", "c <== a * b + b", "e <== c * d"]
WITNESS = {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}
BLINDING = list(range(1, 12))
#: what ``protocol/`` calls on an engine (the contract in ops/engine.py)
CONTRACT = ("poly", "sparse_poly", "intt_poly", "intt_polys", "commit", "commit_many", "eval_polys",
            "linear_combine", "wire_columns", "grand_product_poly", "round3_quotient", "agree")


@pytest.fixture(scope="module")
def proved():
    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    program = Program.from_strs(CIRCUIT, 8)
    engine = TorchEngine("cpu")
    proof = Prover(setup, program, engine=engine).prove(WITNESS, blinding=BLINDING)
    return setup, program, engine, proof


def test_proof_bytes_equal_host_engine(proved):
    setup, program, _, proof = proved
    host = Prover(setup, program, engine=HostEngine()).prove(WITNESS, blinding=BLINDING)
    assert proof.to_bytes() == host.to_bytes()


def test_port_verifier_accepts_and_rejects(proved):
    setup, program, engine, proof = proved
    assert Verifier(setup, program, proof, engine=engine).verify([80])
    assert not Verifier(setup, program, proof, engine=engine).verify([81])


@pytest.fixture(scope="module")
def host_rounds():
    """A HostEngine prover after a prove at n = 16, for its round operands."""
    setup = Setup.generate_srs(16 + 6, tau=101, cache=False)
    prover = Prover(setup, Program.from_strs(CIRCUIT, 16), engine=HostEngine())
    prover.prove(WITNESS, blinding=BLINDING)
    return prover


def _trimmed(p) -> list[int]:
    values = list(p.values)
    while values and values[-1] == 0:
        values.pop()
    return values


def test_engine_contract_ops_match_host(host_rounds):
    engine, host = TorchEngine("cpu"), HostEngine()
    vals = field_ints(31, fr.Q, 16)
    assert engine.ntt(vals) == host.ntt(vals)
    assert engine.intt(vals) == host.intt(vals)
    roots = fr.roots_of_unity(16)
    cols = [field_ints(32 + i, fr.Q, 16) for i in range(6)]
    args = (*cols, roots, 5, 7, 2, 3)
    assert engine.grand_product(*args) == host.grand_product(*args)
    # round 1: the columns of a witness with a value above Q and a negative one
    prover = host_rounds
    table = prover.program.wire_table()
    witness = dict(WITNESS, a=3 + fr.Q, b=4 - 2 * fr.Q)
    got, want = engine.wire_columns(table, witness), host.wire_columns(table, witness)
    assert [(p.basis, p.values) for p in got] == [(p.basis, p.values) for p in want]
    assert [p.values[:3] for p in want] == [[80, 3, 16], [0, 4, 5], [0, 16, 80]]
    # round 2 over columns that do not close, and over the prove's, which do
    for abc in (cols[:3], [p.values for p in (prover.a, prover.b, prover.c)]):
        gp = (prover.pk, 5, 7, K1, K2)
        z, closing = engine.grand_product_poly(*(engine.poly(v, Basis.LAGRANGE) for v in abc), *gp)
        hz, hclosing = host.grand_product_poly(*(host.poly(v, Basis.LAGRANGE) for v in abc), *gp)
        assert (z.basis, z.values) == (hz.basis, hz.values) and len(z) == 16
        assert closing.values == hclosing.values
    assert hclosing.values == [1]
    # round 3 on the prove's operands
    pre, ch = prover.pre, prover.ch
    r3 = (prover.a_coeff, prover.b_coeff, prover.c_coeff, prover.z_coeff, prover.z_omega_coeff,
          pre.s1, pre.s2, pre.s3, pre.ql, pre.qr, pre.qm, pre.qo, pre.qc, prover.pi_coeff, prover._l1_coeff(),
          ch.beta, ch.gamma, ch.alpha, K1, K2, 16)
    t = engine.round3_quotient(*r3, pk_cache=None)
    assert t.basis == Basis.MONOMIAL and _trimmed(t) == _trimmed(host.round3_quotient(*r3, pk_cache=None))


@pytest.mark.parametrize("kind", ["host", "torch", "mesh"])
def test_every_engine_has_the_whole_contract(kind):
    engine = {"host": HostEngine, "torch": lambda: TorchEngine("cpu"),
              "mesh": lambda: MeshEngine(make_mesh(2, device="cpu"))}[kind]()
    assert engine.name == kind
    missing = [m for m in CONTRACT if not callable(getattr(engine, m, None))]
    assert missing == []
    assert engine.agree([1, fr.Q - 1]) == [1, fr.Q - 1]


def test_engine_packs_host_polys():
    """Host Polys given to the engine are packed onto its device and take
    the device path (commit, evaluation, linear combination); an all-zero
    polynomial commits to the identity."""
    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    engine, host = TorchEngine("cpu"), HostEngine()
    p, q = (Poly(field_ints(40 + i, fr.Q, 8 - 3 * i), Basis.MONOMIAL) for i in range(2))
    zero = Poly([0], Basis.MONOMIAL)
    got = engine.commit_many(setup, [p, q, zero])
    assert got == host.commit_many(setup, [p, q, zero])
    assert got[2].is_identity() and engine.commit(setup, zero).is_identity()
    assert engine.eval_polys([p, q], 77) == host.eval_polys([p, q], 77)
    got = engine.linear_combine([p, q], [3, 5], 7)
    assert got.values == host.linear_combine([p, q], [3, 5], 7).values


def test_cuda_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TorchEngine("cuda")


def test_setup_without_points_raises():
    setup = Setup(None, None, n_powers=4)
    with pytest.raises(ValueError):
        setup_points(setup, "cpu")


def test_default_engine_is_torch_cuda(monkeypatch):
    from baby_plonk_tpu_torch.ops import engine as engine_mod

    monkeypatch.delenv("BPT_ENGINE", raising=False)
    monkeypatch.setattr(engine_mod, "_default_engine", None)
    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    program = Program.from_strs(CIRCUIT, 8)
    if torch.cuda.is_available():
        assert Prover(setup, program).engine.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            Prover(setup, program)


@pytest.mark.slow
def test_proof_bytes_equal_tpu_engine():
    """Byte equality with the JAX package's TpuEngine at n = 8, each
    package driven with its own objects."""
    from baby_plonk_tpu.ops.tpu_engine import TpuEngine
    from baby_plonk_tpu.protocol.program import Program as JProgram
    from baby_plonk_tpu.protocol.prover import Prover as JProver
    from baby_plonk_tpu.protocol.setup import Setup as JSetup

    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    program = Program.from_strs(CIRCUIT, 8)
    port = Prover(setup, program, engine=TorchEngine("cpu")).prove(WITNESS, blinding=BLINDING)
    jsetup = JSetup.generate_srs(8 + 6, tau=101, cache=False)
    jprogram = JProgram.from_strs(CIRCUIT, 8)
    tpu = JProver(jsetup, jprogram, engine=TpuEngine()).prove(WITNESS, blinding=BLINDING)
    assert port.to_bytes() == tpu.to_bytes()
