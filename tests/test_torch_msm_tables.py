"""Port fixed-base table build (plain CPU path) against the JAX package's
msm_fixed._build_tables on the same 64 points, compared as affine points."""
import numpy as np

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm_fixed as jmf
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.ops import g1_vec, msm_fixed

from torch_port_util import g1_points, jax_points, one_torch_thread  # noqa: F401  (fixture)


def test_build_tables_match_jax():
    pts = g1_points(11, 64)
    jpts = jg1.points_to_device(jax_points(pts))
    tpts = g1_vec.points_to_device(pts, "cpu")
    # the same Montgomery limbs on both sides of the codec
    for j, t in zip(convert.srs_to_numpy(tpts), jpts):
        assert np.array_equal(j, np.asarray(t))
    want = tuple(np.asarray(t) for t in jmf._build_tables(*jpts))  # (24, 8, 256) x2
    got = msm_fixed.build_tables(*convert.srs_to_torch([np.asarray(c) for c in jpts]))
    assert got[0].shape == (24, 8, 256)
    for g, w in zip(convert.tables_to_numpy(got), want):
        assert np.array_equal(g, w.astype(np.uint32))
    # entry 0 is the (0, 0) identity marker; entry 2^j is point 8g + j
    assert not got[0][:, :, 0].any() and not got[1][:, :, 0].any()
    x, y = (g1_vec.FQ.unpack_mont(t[:, 3, 4].reshape(24, 1))[0] for t in got)
    assert pts[8 * 3 + 2].to_affine() == (x, y)
