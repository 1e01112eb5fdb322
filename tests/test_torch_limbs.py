"""Port limb arithmetic (baby_plonk_tpu_torch.ops.limbs, plain CPU path)
against the JAX package's limbs module on the same inputs. Exact."""
import functools
import os
import re

import jax
import numpy as np
import pytest

from baby_plonk_tpu.fields import fq, fr
from baby_plonk_tpu.ops import limbs as jl
from baby_plonk_tpu_torch.ops import limbs as tl

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

SPECS = {
    "fr": (jl.FieldSpec(fr.Q, 16), tl.FR),
    "fq": (jl.FieldSpec(fq.P, 24), tl.FQ),
}


def _ints(seed, modulus, n):
    """n residues from a seed, the last three 0, 1 and p - 1."""
    return field_ints(seed, modulus, n)[: n - 3] + [0, 1, modulus - 1]


def _jax_ints(jspec, a):
    return jspec.unpack_mont(np.asarray(a))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_constants_match_jax_spec(field):
    jspec, tspec = SPECS[field]
    assert (tspec.R, tspec.R2, tspec.NPRIME) == (jspec.R, jspec.R2, jspec.NPRIME)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_codecs_roundtrip(field):
    _, tspec = SPECS[field]
    xs = _ints(1, tspec.modulus, 40)
    assert tspec.unpack_mont(tspec.pack_mont(xs, "cpu")) == xs
    assert tspec.unpack_raw(tspec.pack_raw(xs, "cpu")) == xs
    # Montgomery limbs are the JAX package's integers
    jspec, _ = SPECS[field]
    assert np.array_equal(tspec.pack_mont(xs, "cpu").numpy(), jspec.pack_mont(xs).astype(np.int32))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_elementwise_ops_match_jax(field):
    jspec, tspec = SPECS[field]
    xs, ys = _ints(2, tspec.modulus, 64), _ints(3, tspec.modulus, 64)[::-1]
    ja, jb = jspec.pack_mont(xs), jspec.pack_mont(ys)
    ta, tb = tspec.pack_mont(xs, "cpu"), tspec.pack_mont(ys, "cpu")
    for jfn, tfn in (
        (jl.mont_mul_jit, tl.mont_mul),
        (jl.add_mod_jit, tl.add_mod),
        (jl.sub_mod_jit, tl.sub_mod),
    ):
        assert tspec.unpack_mont(tfn(tspec, ta, tb)) == _jax_ints(jspec, jfn(jspec, ja, jb))
    assert tspec.unpack_mont(tl.neg_mod(tspec, ta)) == _jax_ints(jspec, jl.neg_mod_jit(jspec, ja))
    assert tspec.unpack_raw(tl.from_mont(tspec, ta)) == xs
    assert tl.to_mont(tspec, tspec.pack_raw(xs, "cpu")).tolist() == ta.tolist()


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_batch_inverse_matches_jax(field):
    jspec, tspec = SPECS[field]
    xs = _ints(4, tspec.modulus, 16)
    xs[5] = 0
    with jl.compact_mul():  # the compile-light product form (same values)
        inv = jax.jit(functools.partial(jl.batch_inverse, jspec))(jspec.pack_mont(xs))
    want = _jax_ints(jspec, inv)
    got = tspec.unpack_mont(tl.batch_inverse(tspec, tspec.pack_mont(xs, "cpu")))
    assert got == want == [pow(x, -1, tspec.modulus) if x else 0 for x in xs]


def test_broadcast_patterns():
    """The kernels' (div, mod) index map covers the broadcasts the port
    uses; anything else is materialized."""
    assert tl._bcast((1, 5, 1), (3, 5, 7)) == (7, 5)
    assert tl._bcast((5,), (3, 5)) == (1, 5)
    assert tl._bcast((3, 1), (3, 5)) == (5, 3)
    assert tl._bcast((1,), (8, 8))[1] == 1  # one element for every lane
    assert tl._bcast((3, 1, 7), (3, 5, 7)) is None
    spec = tl.FR
    a = spec.pack_mont(_ints(5, spec.modulus, 12), "cpu").reshape(16, 3, 4)
    s = spec.pack_mont([7], "cpu")
    assert spec.unpack_mont(tl.mont_mul(spec, a, s)) == [
        x * 7 % spec.modulus for x in spec.unpack_mont(a)
    ]


def test_cuda_constants_match_fields():
    """The word constants written into csrc/field.cuh are Montgomery R^2
    and 1 and p - 2; the moduli and -p^-1 mod 2^32 are immediates of the
    carry chains that ops/field_asm.py writes for it."""
    from baby_plonk_tpu_torch.ops import field_asm

    path = os.path.join(os.path.dirname(tl.__file__), "..", "csrc", "field.cuh")
    src = open(path).read()

    def words(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return sum(int(w.strip().rstrip("u"), 16) << (32 * i) for i, w in enumerate(body.split(",")))

    for tag, p, n in (("FR", fr.Q, 8), ("FQ", fq.P, 12)):
        R = (1 << (32 * n)) % p
        assert words(tag + "_R2") == R * R % p
        assert words(tag + "_ONE") == R
        assert words(tag + "_PM2") == p - 2
        # the reduction rows: m = x0 * (-p^-1), then one multiply-add per word of p
        mul = field_asm.functions()[tag.lower() + "_mul"][0]
        pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
        assert {srcs[1] for op, _, srcs in mul.lines if op == "mul.lo.u32" and isinstance(srcs[1], int)} == {pinv}
        used = {srcs[0] for op, _, srcs in mul.lines if op.startswith("mad") and isinstance(srcs[0], int)}
        assert used == set(field_asm.words(p, n))
