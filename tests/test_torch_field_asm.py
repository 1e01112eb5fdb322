"""The inline-PTX carry chains of the port's field arithmetic
(``baby_plonk_tpu_torch/ops/field_asm.py``, built into ``csrc/field.cuh``):
the emitted PTX text of every function, run by the module's interpreter on
32-bit words, against exact integer arithmetic and against the JAX package's
``limbs.mont_mul`` on the same operands. Edge operands (0, 1, p - 1, R mod p,
R^2 mod p, words of all ones, (p - 1)^2) find a dropped carry that random
operands miss. Tolerance: exact (integers)."""
import jax.numpy as jnp
import numpy as np
import pytest

from baby_plonk_tpu.ops import limbs as jlimbs
from baby_plonk_tpu_torch.ops import field_asm
from baby_plonk_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

from torch_port_util import field_ints

FIELDS = sorted(field_asm.FIELDS)


def edge_operands(field: str) -> list[int]:
    p, n = field_asm.FIELDS[field]
    R = 1 << (32 * n)
    top = p >> (32 * (n - 1))
    ones_below_p = ((top - 1) << (32 * (n - 1))) | ((1 << (32 * (n - 1))) - 1)
    return [0, 1, p - 1, R % p, R * R % p, ones_below_p, (p - 1) ** 2 % p, (1 << (32 * (n - 1))) - 1]


def operands(field: str) -> list[int]:
    return edge_operands(field) + field_ints(7, field_asm.FIELDS[field][0], 6)


@pytest.mark.parametrize("field", FIELDS)
def test_mul_matches_integers(field):
    p, n = field_asm.FIELDS[field]
    r_inv = pow(1 << (32 * n), -1, p)
    for a in operands(field):
        for b in operands(field):
            assert field_asm.run(f"{field}_mul", a, b) == a * b * r_inv % p, (hex(a), hex(b))


@pytest.mark.parametrize("field", FIELDS)
def test_sqr_matches_integers(field):
    p, n = field_asm.FIELDS[field]
    r_inv = pow(1 << (32 * n), -1, p)
    for a in operands(field) + field_ints(8, p, 40):
        assert field_asm.run(f"{field}_sqr", a) == a * a * r_inv % p, hex(a)


@pytest.mark.parametrize("field", FIELDS)
def test_add_sub_match_integers(field):
    p, _ = field_asm.FIELDS[field]
    for a in operands(field):
        for b in operands(field):
            assert field_asm.run(f"{field}_add", a, b) == (a + b) % p
            assert field_asm.run(f"{field}_sub", a, b) == (a - b) % p


def test_fq_lazy_operands_stay_inside_the_bound():
    """The unreduced sums g1.cuh feeds into a product: a, b < 2p, and
    a < p with b < 8p; the product is canonical all the same."""
    p, n = field_asm.FIELDS["fq"]
    r_inv = pow(1 << (32 * n), -1, p)
    for a, b in ((2 * p - 2, 2 * p - 2), (p - 1, 8 * p - 8), (2 * p - 2, 1), (0, 8 * p - 8)):
        assert field_asm.run("fq_mul", a, b) == a * b * r_inv % p
    assert field_asm.run("fq_add_lazy", p - 1, p - 1) == 2 * p - 2
    s = field_asm.run("fq_add_lazy", p - 1, p - 1)
    assert field_asm.run("fq_add_lazy", field_asm.run("fq_add_lazy", s, s), 4 * p - 4) == 8 * p - 8


@pytest.mark.parametrize("field", FIELDS)
def test_mul_matches_jax_mont_mul(field):
    p, n = field_asm.FIELDS[field]
    spec = jlimbs.FieldSpec(p, 2 * n)
    a, b = operands(field), list(reversed(operands(field)))
    want = np.asarray(jlimbs.mont_mul(spec, jnp.asarray(ints_to_limbs(a, 2 * n).astype(np.uint32)),
                                      jnp.asarray(ints_to_limbs(b, 2 * n).astype(np.uint32))))
    got = [field_asm.run(f"{field}_mul", x, y) for x, y in zip(a, b)]
    assert got == limbs_to_ints(want)


def test_header_has_one_asm_statement_per_function():
    text = field_asm.header()
    names = list(field_asm.functions())
    assert text.count("asm(") == len(names) == 9
    for name in names:
        assert f"void {name}(" in text
    # every carry-reading instruction follows a carry-writing one of its own statement
    for s, _ in field_asm.functions().values():
        open_chain = False
        for op, _, _ in s.lines:
            parts = op.split(".")
            if parts[0] in ("addc", "subc", "madc"):
                assert open_chain, op
            if parts[0] in ("add", "sub", "mad", "addc", "subc", "madc"):
                open_chain = "cc" in parts
