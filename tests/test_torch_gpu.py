"""Card-only checks of the port's CUDA kernels against their plain
versions at small shapes (the full-size checks are chip_smoke.py's).
They skip where torch.cuda.is_available() is false."""
import numpy as np
import pytest
import torch

from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm, msm_fixed, msm_pippenger, ntt, srs

from torch_port_util import field_ints

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu tests/test_torch_gpu.py)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("spec", [limbs.FR, limbs.FQ], ids=["fr", "fq"])
def test_field_ops(dev, spec):
    a = spec.pack_raw(field_ints(1, spec.modulus, 1000), dev)
    b = spec.pack_raw(field_ints(2, spec.modulus, 1000), dev)
    for fn, plain in ((limbs.mont_mul, limbs._mont_mul_plain), (limbs.add_mod, limbs._add_plain),
                      (limbs.sub_mod, limbs._sub_plain)):
        assert torch.equal(fn(spec, a, b).long(), plain(spec, a, b))
        assert torch.equal(fn(spec, a.reshape(spec.L, 10, 100), b[:, :100]).long(),
                           plain(spec, a.reshape(spec.L, 10, 100), b[:, :100]))
    assert torch.equal(limbs.neg_mod(spec, a).long(), limbs._neg_plain(spec, a))
    with pytest.raises(TypeError):
        limbs.mont_mul(spec, a.long(), b)
    with pytest.raises(ValueError):
        limbs.mont_mul(spec, a, b.cpu())


@pytest.mark.parametrize("m", [2, 8, 64, 1024])
def test_ntt_sub(dev, m):
    B = 4
    x = limbs.FR.pack_mont(field_ints(3, fr.Q, m * B), dev).reshape(16, 1, m, B)
    for inverse in (False, True):
        pw = ntt.sub_twiddles(m, inverse, dev)
        assert torch.equal(kernels.ntt_sub(x, inverse).long(), kernels.ntt_sub_plain(x, pw))


def test_ntt_device(dev):
    x = limbs.FR.pack_mont(field_ints(4, fr.Q, 3 * 4096), dev).reshape(16, 3, 4096)
    for inverse in (False, True):
        assert torch.equal(ntt.ntt_device(x, inverse), ntt.ntt_device(x, inverse, plain=True))
    assert torch.equal(ntt.ntt_device(ntt.ntt_device(x), inverse=True), x)


def test_prove_cpu_then_cuda_same_bytes(dev):
    """One program proved by the CPU engine, then by the CUDA engine (its
    proving key then holds CPU coefficient caches): equal proof bytes."""
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup

    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    program = Program.from_strs(["e public", "c <== a * b + b", "e <== c * d"], 8)
    witness, blinding = {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}, list(range(1, 12))
    cpu = Prover(setup, program, TorchEngine("cpu")).prove(witness, blinding=blinding)
    cuda = Prover(setup, program, TorchEngine(dev)).prove(witness, blinding=blinding)
    assert cpu.to_bytes() == cuda.to_bytes()


def test_msm_and_srs(dev):
    pts = srs.powers_of_tau_device(64, 99, dev)
    cpu = srs.powers_of_tau_device(64, 99, "cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(pts, cpu))
    tx, ty = msm_fixed.build_tables(*pts)
    px, py = msm_fixed.build_tables_plain(*pts)
    assert torch.equal(tx.long(), px) and torch.equal(ty.long(), py)
    sc = limbs.FR.pack_raw(field_ints(5, fr.Q, 128), dev).reshape(16, 2, 64)
    got = msm_fixed.msm_fixed_horner(tx, ty, sc)
    want = msm_fixed.msm_fixed_plain(tx, ty, sc)
    assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    red = g1_vec.tree_reduce(got)
    assert g1_vec.points_from_device(red) == g1_vec.points_from_device(
        g1_vec.tree_reduce(tuple(c.cpu() for c in got)))
    np.testing.assert_equal(len(g1_vec.points_from_device(red)), 2)


def test_msm_partials_and_pdouble(dev):
    """The bit-serial tile kernel and the doubling launcher against their
    plain versions, limb for limb; both MSM algorithms against the exact
    host MSM (ragged n, a zero scalar, Q - 1)."""
    from baby_plonk_tpu_torch.curves import msm_host

    n = 96
    pts = srs.powers_of_tau_device(n, 77, dev)
    ints = field_ints(6, fr.Q, n)
    ints[0], ints[1] = 0, fr.Q - 1
    sc = limbs.FR.pack_raw(ints, dev)
    for tile in (32, 8):
        got = msm.msm_partials(pts, sc, tile=tile)
        want = msm.msm_partials_plain(pts, sc, tile=tile)
        assert got[0].shape == (24, n // tile)
        assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        msm.msm_partials(pts, sc, tile=64)  # 96 is no multiple of 64
    dbl = g1_vec.pdouble(pts)
    assert all(torch.equal(g.long(), w) for g, w in zip(dbl, g1_vec.pdouble_plain(g1_vec._to64(pts))))
    # the shape the Pippenger window shift gives both launchers: one point, (24,) x3
    one, other = (tuple(c[:, i].contiguous() for c in pts) for i in (3, 4))
    assert all(torch.equal(g.long(), w) for g, w in zip(
        g1_vec.pdouble(one), g1_vec.pdouble_plain(g1_vec._to64(one))))
    assert all(torch.equal(g.long(), w) for g, w in zip(
        g1_vec.padd(one, other), g1_vec.padd_plain(g1_vec._to64(one), g1_vec._to64(other))))
    host = msm_host.msm(g1_vec.points_from_device(pts), ints)
    padded = (tuple(torch.cat([c, c[:, :1].expand(24, 32)], -1) for c in pts),
              torch.cat([sc, sc.new_zeros(16, 32)], -1))
    assert g1_vec.point_from_device(msm.msm_bitserial(*padded)) == host
    assert g1_vec.point_from_device(msm_pippenger.msm_pippenger(pts, sc, c=8)) == host
