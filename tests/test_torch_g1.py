"""Port G1 point formulas (plain CPU path) against the JAX package's
g1_vec on the same points: equal projective coordinates, and equal to the
host curve."""
import jax
import numpy as np

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.ops import g1_vec

from torch_port_util import g1_points, jax_points, one_torch_thread  # noqa: F401  (fixture)


def _same(port, jax_pts):
    for t, j in zip(convert.srs_to_numpy(port), jax_pts):
        assert np.array_equal(t, np.asarray(j))


def test_point_formulas_match_jax():
    ps = g1_points(21, 6) + [G1.identity(), G1.generator()]
    qs = g1_points(22, 6) + [G1.generator(), G1.generator()]  # id + P and P + P
    jp, jq = jg1.points_to_device(jax_points(ps)), jg1.points_to_device(jax_points(qs))
    tp, tq = g1_vec.points_to_device(ps, "cpu"), g1_vec.points_to_device(qs, "cpu")
    _same(tp, jp)
    s = g1_vec.padd(tp, tq)
    _same(s, jax.jit(jg1.padd)(jp, jq))
    d = g1_vec._to32(g1_vec.pdouble_plain(g1_vec._to64(tp)))
    _same(d, jax.jit(jg1.pdouble)(jp))
    m = g1_vec._to32(g1_vec.padd_mixed_plain(g1_vec._to64(tp), tq[0].long(), tq[1].long()))
    _same(m, jax.jit(jg1.padd_mixed)(jp, jq[:2]))
    assert g1_vec.points_from_device(s) == [p + q for p, q in zip(ps, qs)]
    assert g1_vec.points_from_device(d) == [p.double() for p in ps]


def test_tree_reduce_and_normalize():
    ps = g1_points(23, 7) + [G1.identity()]
    t = g1_vec.points_to_device(ps, "cpu")
    total = G1.identity()
    for p in ps:
        total = total + p
    assert g1_vec.point_from_device(g1_vec.tree_reduce(t)) == total
    assert g1_vec.point_from_device(g1_vec.combine_partials(tuple(c[:, :5] for c in t))) == sum(
        ps[1:5], ps[0])
    x, y = g1_vec.batch_normalize(t)
    aff = [p.to_affine() for p in ps]
    got = list(zip(g1_vec.FQ.unpack_mont(x), g1_vec.FQ.unpack_mont(y)))
    assert got == [a if a is not None else (0, 0) for a in aff]
