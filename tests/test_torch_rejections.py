"""The port's soundness paths against the JAX package's verdicts on the same
proof bytes and points: ``protocol.verifier.batch_verify`` (the cases of
tests/test_batch_verify.py: a batch of good proofs accepted, one bad proof
or one wrong public input sinking the batch, the empty batch) and the
subgroup checks of ``curves/g1.py`` and ``curves/g2.py`` (the cases of
tests/test_subgroup_checks.py: cofactor points rejected by
``is_torsion_free``, non-subgroup bytes rejected by ``from_compressed``).
Host engines at n = 8, CPU only."""
import numpy as np
import pytest

from baby_plonk_tpu.curves.g1 import G1 as JG1
from baby_plonk_tpu.curves.g2 import G2 as JG2
from baby_plonk_tpu.fields.tower import Fp2 as JFp2
from baby_plonk_tpu.ops.engine import HostEngine as JHostEngine
from baby_plonk_tpu.protocol.program import Program as JProgram
from baby_plonk_tpu.protocol.proof import Proof as JProof
from baby_plonk_tpu.protocol.setup import Setup as JSetup
from baby_plonk_tpu.protocol.verifier import Verifier as JVerifier
from baby_plonk_tpu.protocol.verifier import batch_verify as jbatch_verify
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.curves.g2 import B2, G2
from baby_plonk_tpu_torch.fields import fq
from baby_plonk_tpu_torch.fields.fr import Q as R
from baby_plonk_tpu_torch.fields.tower import Fp2
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.protocol import Program, Proof, Prover, Setup, Verifier
from baby_plonk_tpu_torch.protocol.verifier import batch_verify

N = 8
TAU = 2718
CIRCUITS = {
    "a": ["e public", "c <== a * b + b", "e <== c * d"],
    "b": ["s public", "xx <== x * x", "s <== xx * 1 + y"],
}
#: (circuit, witness, public input): the three proofs of tests/test_batch_verify.py
PROOFS = [
    ("a", {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}, [80]),
    ("b", {"x": 11, "xx": 121, "y": 7, "s": 128}, [128]),
    ("a", {"a": 2, "b": 5, "c": 15, "d": 3, "e": 45}, [45]),
]
#: cofactors of E(Fp) and E'(Fp2) (the standard BLS12-381 parameters)
H1 = 0x396C8C005555E1568C00AAAB0000AAAB
H2 = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5


@pytest.fixture(scope="module")
def batch():
    """The port's setup, programs and proof bytes (HostEngine, fixed
    blinding), beside the JAX package's setup and programs."""
    setup, jsetup = Setup.generate_srs(N + 6, tau=TAU, cache=False), JSetup.generate_srs(N + 6, tau=TAU, cache=False)
    progs = {k: Program.from_strs(c, N) for k, c in CIRCUITS.items()}
    jprogs = {k: JProgram.from_strs(c, N) for k, c in CIRCUITS.items()}
    engine = HostEngine()
    blobs = [Prover(setup, progs[k], engine).prove(w, blinding=list(range(i + 1, i + 12))).to_bytes()
             for i, (k, w, _) in enumerate(PROOFS)]
    return setup, jsetup, progs, jprogs, blobs


def _verdicts(batch, cases):
    """batch_verify of each package on ``cases``: lists of (circuit, proof
    bytes, public input)."""
    setup, jsetup, progs, jprogs, _ = batch
    engine, jengine = HostEngine(), JHostEngine()
    port = batch_verify([(Verifier(setup, progs[k], Proof.from_bytes(b), engine=engine), pub) for k, b, pub in cases])
    ref = jbatch_verify([(JVerifier(jsetup, jprogs[k], JProof.from_bytes(b), engine=jengine), pub)
                         for k, b, pub in cases])
    return port, ref


def _good(batch):
    return [(k, blob, pub) for (k, _, pub), blob in zip(PROOFS, batch[4])]


def test_batch_verify_accepts_as_jax(batch):
    assert _verdicts(batch, _good(batch)) == (True, True)
    assert _verdicts(batch, []) == (True, True)  # the vacuous batch
    for case in _good(batch):
        assert _verdicts(batch, [case]) == (True, True)
        setup, _, progs, _, _ = batch
        assert Verifier(setup, progs[case[0]], Proof.from_bytes(case[1]), engine=HostEngine()).verify(case[2])


def test_batch_verify_rejects_as_jax(batch):
    good = _good(batch)
    bad = bytearray(good[1][1])
    bad[600] ^= 1  # a scalar byte of the second proof
    assert _verdicts(batch, [good[0], (good[1][0], bytes(bad), good[1][2]), good[2]]) == (False, False)
    # a wrong public input alone sinks the batch
    wrong = good[:2] + [(good[2][0], good[2][1], [good[2][2][0] + 1])]
    assert _verdicts(batch, wrong) == (False, False)


def _field(rng) -> int:
    return int.from_bytes(rng.bytes(48), "little") % fq.P


def _curve_point_g1(rng) -> G1:
    """A point of E(Fp) sampled by x: in the r-subgroup with probability 1/h1."""
    while True:
        x = _field(rng)
        y = fq.sqrt((x * x % fq.P * x + 4) % fq.P)
        if y is not None:
            return G1.from_affine(x, y)


def _curve_point_g2(rng) -> G2:
    while True:
        x = Fp2(_field(rng), _field(rng))
        y = (x.square() * x + B2).sqrt()
        if y is not None:
            return G2.from_affine(x, y)


def _jax_g1(p: G1):
    return JG1.identity() if p.is_identity() else JG1.from_affine(*p.to_affine())


def _jax_g2(p: G2):
    if p.is_identity():
        return JG2.identity()
    x, y = p.to_affine()
    return JG2.from_affine(JFp2(x.c0, x.c1), JFp2(y.c0, y.c1))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_subgroup_checks_as_jax(group):
    """Cofactor points: rejected by is_torsion_free (their cleared multiples
    accepted) and, as compressed bytes, by from_compressed; subgroup points
    accepted by both. Each verdict equal to the JAX package's."""
    rng = np.random.default_rng(777 if group == "g1" else 778)
    cls, jcls, sample, to_jax, h, gen = (
        (G1, JG1, _curve_point_g1, _jax_g1, H1, G1.generator())
        if group == "g1" else (G2, JG2, _curve_point_g2, _jax_g2, H2, G2.generator()))
    rejected = 0
    for _ in range(3 if group == "g1" else 2):
        p = sample(rng)
        assert p.is_on_curve()
        cleared = p._mul_int(h)
        for q in (p, cleared):
            assert q.is_torsion_free() == to_jax(q).is_torsion_free()
        assert cleared.is_torsion_free()
        if not p._mul_int(R).is_identity():  # outside the subgroup (probability 1 - 1/h)
            rejected += 1
            assert not p.is_torsion_free()
            data = p.to_compressed()
            assert cls.from_compressed(data) is None and jcls.from_compressed(data) is None
    assert rejected > 0
    inside = gen * 12345
    assert inside.is_torsion_free() and to_jax(inside).is_torsion_free()
    data = inside.to_compressed()
    assert cls.from_compressed(data) == inside and jcls.from_compressed(data) == to_jax(inside)
