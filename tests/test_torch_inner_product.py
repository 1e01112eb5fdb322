"""The int8 inner product (``circuits/library.py::inner_product``), the
circuit of the benchmark's ``plonk16-innerprod-fb``, on the CPU: uint8
activations against int8 weights, two witness values a row, two kinds of
gate row and a copy cycle of one cell for every a_i and b_i.

A prove on ``TorchEngine("cpu")`` (its commitments by the host MSM, as in
``test_torch_witness_codec.py``: the plain MSM is held elsewhere) gives
``HostEngine``'s bytes, with the weights passed reduced and as negative
Python ints, and verifies; a wrong public sum is rejected. Round 1 reads
the host engine's columns on a miss and on a native hit. The same instance
proves to the same bytes in the JAX package, whose keygen and permutation
are its own: the oracle for the two gate kinds and the singleton copy
cycles, which the port's two engines share.
"""
import random

import pytest

from baby_plonk_tpu_torch import native
from baby_plonk_tpu_torch.circuits.library import inner_product
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Proof, Prover, Setup, Verifier
from baby_plonk_tpu_torch.protocol.poly import Poly
from baby_plonk_tpu_torch.utils.metrics import get_metrics

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

Q = fr.Q
PAIRS = 15
N = 2 * PAIRS + 2  # the public row, two rows a pair, the sum's row: 32
BLINDING = [Q - 1, 2, 3 * Q + 5, 4, 5, 6, 7, 8, 9, 10, 11]
NATIVE = native.witness_reader() is not None


def _pairs(seed: int) -> list:
    """uint8 activations against int8 weights, at least one weight negative."""
    rng = random.Random(seed)
    pairs = [(rng.randrange(256), rng.randrange(-128, 128)) for _ in range(PAIRS)]
    return pairs[:-1] + [(255, -128)]


def _instance(seed: int, weights: str):
    """(witness, public) of ``inner_product`` over ``_pairs(seed)``, the
    weights reduced (as the port's circuit gives them) or put back as the
    negative ints they were drawn as (the same residues); and the count of
    negative weights."""
    pairs = _pairs(seed)
    _, witness, public = inner_product(pairs)
    if weights == "negative":
        witness.update({f"b{i}": b for i, (_, b) in enumerate(pairs) if b < 0})
    return witness, public, sum(b < 0 for _, b in pairs)


def _program():
    return Program.from_strs(inner_product(_pairs(0))[0], N)


class HostCommits(TorchEngine):
    """TorchEngine("cpu") with every commitment made by the host MSM."""

    def commit_many(self, setup, polys):
        return [setup.commit(Poly(p.values, p.basis)) for p in polys]


def _counted(fn):
    m = get_metrics()
    m.reset()
    out = fn()
    counters = dict(m.counters)
    m.reset()
    return out, counters


@pytest.mark.parametrize("weights", ["reduced", "negative"])
def test_the_int8_inner_product_proves_as_the_host_engine(weights):
    setup = Setup.generate_srs(N + 6, 0xDEADBEEF, cache=False)
    program = _program()
    assert len(program.wire_table().names) == 4 * PAIRS + 1
    device = Prover(setup, program, HostCommits("cpu"))
    for seed, hit in [(1, False), (2, NATIVE)]:  # the first witness teaches the table its key order
        witness, public, _ = _instance(seed, weights)
        got, counters = _counted(lambda: device.prove(witness, blinding=BLINDING).to_bytes())
        want = Prover(setup, program, HostEngine()).prove(witness, blinding=BLINDING).to_bytes()
        assert got == want
        assert (counters.get("witness_order_hits", 0), counters.get("witness_order_misses", 0)) == (hit, not hit)
    proof = Proof.from_bytes(got)
    assert Verifier(setup, program, proof, engine=HostEngine()).verify(public)
    assert not Verifier(setup, program, proof, engine=HostEngine()).verify([(public[0] + 1) % Q])


@pytest.mark.parametrize("weights", ["reduced", "negative"])
def test_round_one_reads_the_host_engines_columns(weights):
    """The first witness misses and teaches the table its key order; the
    next are read by the native pass (where it builds), the negative
    weights among them left to Python and reduced there."""
    table = _program().wire_table()
    eng, host = TorchEngine("cpu"), HostEngine()
    for k, seed in enumerate([3, 4, 5]):
        witness, _, negative = _instance(seed, weights)
        assert negative > 0
        cols, counters = _counted(lambda: eng.wire_columns(table, witness))
        assert [c.values for c in cols] == [c.values for c in host.wire_columns(table, witness)]
        assert counters.get("witness_order_hits", 0) == (NATIVE and k > 0)


@pytest.mark.parametrize("engine", ["host", pytest.param("tpu", marks=pytest.mark.slow)])
@pytest.mark.parametrize("weights", ["reduced", "negative"])
def test_proofs_equal_the_jax_packages(engine, weights):
    """The port's proof of the inner product is byte for byte the JAX
    package's, each package driven with its own Setup, Program and Prover:
    the JAX package's host engine (its Python-int oracle), or its
    TpuEngine (slow on the CPU: its first compile takes minutes)."""
    from baby_plonk_tpu.ops.engine import HostEngine as JHostEngine
    from baby_plonk_tpu.protocol.program import Program as JProgram
    from baby_plonk_tpu.protocol.prover import Prover as JProver
    from baby_plonk_tpu.protocol.setup import Setup as JSetup

    if engine == "tpu":
        from baby_plonk_tpu.ops.tpu_engine import TpuEngine as JEngine
    else:
        JEngine = JHostEngine
    witness, _, _ = _instance(8, weights)
    lines = inner_product(_pairs(8))[0]
    setup = Setup.generate_srs(N + 6, 0xDEADBEEF, cache=False)
    port = Prover(setup, Program.from_strs(lines, N), HostCommits("cpu")).prove(witness, blinding=BLINDING)
    jsetup = JSetup.generate_srs(N + 6, 0xDEADBEEF, cache=False)
    jax = JProver(jsetup, JProgram.from_strs(lines, N), engine=JEngine()).prove(witness, blinding=BLINDING)
    assert port.to_bytes() == jax.to_bytes()
