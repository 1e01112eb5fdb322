"""The port's scan, power and power-table wrappers (plain CPU path, the
versions the CUDA kernels are held against on the card) against the JAX
package's ``doubling_scan`` and ``mont_pow_fixed`` and against Python ints,
on inputs from a numpy seed. Exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baby_plonk_tpu.fields import fq, fr
from baby_plonk_tpu.ops import limbs as jl
from baby_plonk_tpu_torch.ops import limbs as tl

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

JFR, JFQ = jl.FieldSpec(fr.Q, 16), jl.FieldSpec(fq.P, 24)


def _reference(xs, op, reverse, exclusive, p):
    """The scan of one row of ints, written out."""
    seq = xs[::-1] if reverse else xs
    acc, out = (1 if op == "mul" else 0), []
    for x in seq:
        if exclusive:
            out.append(acc)
        acc = acc * x % p if op == "mul" else (acc + x) % p
        if not exclusive:
            out.append(acc)
    return (out[::-1] if reverse else out), acc


@functools.lru_cache(maxsize=None)
def _jax_scan(op):
    if op == "mul":
        combine, ident = (lambda a, b: jl.mont_mul(JFR, a, b)), JFR.one_mont
    else:
        combine, ident = (lambda a, b: jl.add_mod(JFR, a, b)), np.zeros((16, 1), np.uint32)
    return jax.jit(lambda x: jl.doubling_scan(x, combine, ident))


@pytest.mark.parametrize("exclusive", [False, True], ids=["inclusive", "exclusive"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("op", ["mul", "add"])
def test_scan_matches_doubling_scans(op, reverse, exclusive):
    """n = 11 (no power of two) with batch axes (2, 3): against the written-out
    scan, the port's ``doubling_scan`` and the JAX package's."""
    n, batch = 11, (2, 3)
    ints = field_ints(5, fr.Q, 6 * n)
    x = tl.FR.pack_mont(ints, "cpu").reshape((16,) + batch + (n,))
    got, total = tl.field_scan(tl.FR, x, op, reverse, exclusive)
    assert got.dtype == torch.int32 and got.shape == x.shape and total.shape == (16,) + batch + (1,)
    rows = [ints[i * n : (i + 1) * n] for i in range(6)]
    want = [_reference(r, op, reverse, exclusive, fr.Q) for r in rows]
    assert tl.FR.unpack_mont(got) == [v for w, _ in want for v in w]
    assert tl.FR.unpack_mont(total) == [t for _, t in want]
    # the inclusive scan is the doubling scan between two flips
    if op == "mul":
        combine, ident = (lambda a, b: tl.mont_mul(tl.FR, a, b)), tl.FR.one("cpu")
    else:
        combine, ident = (lambda a, b: tl.add_mod(tl.FR, a, b)), torch.zeros((16, 1), dtype=torch.int32)
    inc, _ = tl.field_scan(tl.FR, x, op, reverse, False)
    flipped = x.flip(-1) if reverse else x
    port = tl.doubling_scan(flipped, combine, ident)
    assert torch.equal(inc, port.flip(-1) if reverse else port)
    with jl.compact_mul():
        ref = np.asarray(_jax_scan(op)(jnp.asarray(flipped.numpy().astype(np.uint32))))
    assert np.array_equal(port.numpy(), ref.astype(np.int32))


@pytest.mark.parametrize("n", [1, 2, 7])
def test_scan_short_rows(n):
    ints = field_ints(6, fq.P, n)
    x = tl.FQ.pack_mont(ints, "cpu")
    for op in ("mul", "add"):
        for reverse in (False, True):
            for exclusive in (False, True):
                got, total = tl.field_scan(tl.FQ, x, op, reverse, exclusive)
                want, want_total = _reference(ints, op, reverse, exclusive, fq.P)
                assert tl.FQ.unpack_mont(got) == want and tl.FQ.unpack_mont(total) == [want_total]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_pow_matches_jax_and_ints(field):
    """Edge values 0, 1, p - 1 and random lanes; e = p - 2, small and sparse."""
    jspec, tspec = (JFR, tl.FR) if field == "fr" else (JFQ, tl.FQ)
    p = tspec.modulus
    xs = [0, 1, p - 1] + field_ints(7, p, 5)
    a = tspec.pack_mont(xs, "cpu")
    for e in (p - 2, 1, 2, 5, (1 << 70) + 3):
        got = tl.mont_pow_fixed(tspec, a, e)
        assert got.dtype == torch.int32
        assert tspec.unpack_mont(got) == [pow(x, e, p) for x in xs]
    assert tspec.unpack_mont(tl.mont_pow_fixed(tspec, a, 0)) == [1] * len(xs)
    with jl.compact_mul():
        ref = jl.mont_pow_fixed_jit(jspec, jnp.asarray(a.numpy().astype(np.uint32)), p - 2)
    assert np.array_equal(tl.mont_pow_fixed(tspec, a, p - 2).numpy(), np.asarray(ref).astype(np.int32))


def test_pow_one_lane_shape():
    """The grand product inverts one (16, 1) lane."""
    a = tl.FR.pack_mont([123456789], "cpu")
    assert tl.FR.unpack_mont(tl.mont_pow_fixed(tl.FR, a, fr.Q - 2)) == [pow(123456789, -1, fr.Q)]


@pytest.mark.parametrize("n", [1, 2, 9, 64])
def test_pow_table(n):
    for spec in (tl.FR, tl.FQ):
        z = field_ints(8, spec.modulus, 1)[0]
        got = tl.pow_table(spec, spec.pack_mont([z], "cpu"), n)
        assert got.shape == (spec.L, n) and got.dtype == torch.int32
        assert spec.unpack_mont(got) == [pow(z, i, spec.modulus) for i in range(n)]
    with pytest.raises(ValueError):
        tl.pow_table(tl.FR, tl.FR.pack_mont([1, 2], "cpu"), n)


def test_batch_inverse_batch_axes():
    xs = field_ints(9, fr.Q, 12)
    xs[4] = 0
    a = tl.FR.pack_mont(xs, "cpu").reshape(16, 3, 4)
    got = tl.FR.unpack_mont(tl.batch_inverse(tl.FR, a))
    # one inversion a row of 4: a zero maps to zero and spoils nothing
    assert got == [pow(x, -1, fr.Q) if x else 0 for x in xs]


def test_launch_counters_untouched_on_cpu():
    """A wrapper counts where it launches its kernel, and nowhere else."""
    a = tl.FR.pack_mont([3, 4], "cpu")
    before = [f.launches for f in (tl.mont_pow_fixed, tl.field_scan, tl.pow_table, tl.mont_mul)]
    tl.mont_pow_fixed(tl.FR, a, 3)
    tl.field_scan(tl.FR, a, "mul")
    tl.pow_table(tl.FR, a[:, :1], 4)
    assert [f.launches for f in (tl.mont_pow_fixed, tl.field_scan, tl.pow_table, tl.mont_mul)] == before
