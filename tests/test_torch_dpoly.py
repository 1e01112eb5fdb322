"""Port device polynomials and the round-3/round-5 pipelines (plain CPU
path) against the host Poly oracle of the port's protocol layer."""
import pytest

from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops.dpoly import DPoly, eval_many
from baby_plonk_tpu_torch.ops.prover_kernels import linear_combine_device
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol.poly import Basis, Poly

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

Q = fr.Q


def _pair(seed, n, basis=Basis.MONOMIAL):
    vals = field_ints(seed, Q, n)
    return DPoly.from_ints(vals, basis, "cpu"), Poly(vals, basis)


def test_arithmetic_matches_host():
    (a, ha), (b, hb) = _pair(1, 8), _pair(2, 5)
    assert (a + b).values == (ha + hb).values
    assert (a - b).values == (ha - hb).values
    assert (a * b).values == (ha * hb).values
    assert (a * 7).values == (ha * 7).values
    assert (a + 9).values == (ha + 9).values
    assert (a - 9).values == (ha - 9).values
    assert (-a).values == [(-v) % Q for v in ha.values]
    assert a.rlc(b, 3, 4).values == ha.rlc(hb, 3, 4).values
    (la, hla), (lb, hlb) = _pair(3, 8, Basis.LAGRANGE), _pair(4, 8, Basis.LAGRANGE)
    assert (la * lb).values == (hla * hlb).values
    assert la.to_monomial().values == TorchEngine("cpu").intt_poly(hla).values


def test_eval_divide_scale_slice():
    a, ha = _pair(5, 12)
    z = 123456789
    assert a.eval(z) == ha.eval(z)
    assert eval_many([a, a.slice_coeffs(2, 7)], z) == [ha.eval(z), ha.slice_coeffs(2, 7).eval(z)]
    assert a.scale_domain(5).values == ha.scale_domain(5).values
    assert a.slice_coeffs(10, 16).values == ha.values[10:] + [0] * 4
    num = a - a.eval(z)
    assert num.divide_by_linear(z).values == (ha - ha.eval(z)).divide_by_linear(z).values
    zh = DPoly.vanishing(4, "cpu")
    assert (a * zh).divide_by_vanishing(4).values == ha.values
    assert a.degree() == 11
    with pytest.raises(AssertionError):
        a.divide_by_vanishing(4)


def test_linear_combine_matches_host():
    polys = [_pair(10 + i, 6 + i) for i in range(5)]
    coeffs = field_ints(20, Q, 5)
    got = linear_combine_device([p for p, _ in polys], coeffs, 77)
    want = None
    for (_, hp), c in zip(polys, coeffs):
        want = hp * c if want is None else want + hp * c
    want = want + 77
    assert got.values == want.values
