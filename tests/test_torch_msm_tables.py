"""Port fixed-base table build (plain CPU path) against the JAX package's
msm_fixed._build_tables on the same 64 points: the port's packed tables
(G, 256, 24), brought back to the JAX layout by convert.tables_to_numpy,
equal it limb for limb; so do groups of cancelling, repeated and identity
points."""
import numpy as np
import torch

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm_fixed as jmf
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.ops import g1_vec, msm_fixed

from torch_port_util import edge_groups, g1_points, jax_points, one_torch_thread  # noqa: F401  (fixture)


def test_build_tables_match_jax():
    pts = g1_points(11, 64)
    jpts = jg1.points_to_device(jax_points(pts))
    tpts = g1_vec.points_to_device(pts, "cpu")
    # the same Montgomery limbs on both sides of the codec
    for j, t in zip(convert.srs_to_numpy(tpts), jpts):
        assert np.array_equal(j, np.asarray(t))
    want = tuple(np.asarray(t) for t in jmf._build_tables(*jpts))  # (24, 8, 256) x2
    got = msm_fixed.build_tables(*convert.srs_to_torch([np.asarray(c) for c in jpts], "cpu"))
    assert got.shape == (8, 256, 24) and got.dtype == torch.int32
    for g, w in zip(convert.tables_to_numpy(got), want):
        assert g.shape == (24, 8, 256)
        assert np.array_equal(g, w.astype(np.uint32))
    # entry 0 is the (0, 0) identity marker; entry 2^j is point 8g + j
    assert not got[:, 0].any()
    tx, ty = msm_fixed.unpack_tables(got)
    x, y = (g1_vec.FQ.unpack_mont(t[:, 3, 4].reshape(24, 1))[0] for t in (tx, ty))
    assert pts[8 * 3 + 2].to_affine() == (x, y)
    # the JAX tables cross into the port's layout and back unchanged
    assert torch.equal(convert.tables_to_torch(want, "cpu"), got)


def test_pack_unpack_roundtrip():
    """One entry is x's 12 words then y's, two 16-bit limbs a word, low limb
    first; words above 2^31 keep their bit pattern in int32."""
    rng = np.random.default_rng(21)
    tx, ty = (torch.from_numpy(rng.integers(0, 1 << 16, size=(24, 3, 256)).astype(np.int32)) for _ in range(2))
    packed = msm_fixed.pack_tables(tx, ty)
    assert packed.shape == (3, 256, 24) and packed.is_contiguous()
    assert int(packed[2, 7, 0]) & 0xFFFFFFFF == int(tx[0, 2, 7]) | int(tx[1, 2, 7]) << 16
    assert int(packed[1, 9, 23]) & 0xFFFFFFFF == int(ty[22, 1, 9]) | int(ty[23, 1, 9]) << 16
    back = msm_fixed.unpack_tables(packed)
    assert torch.equal(back[0], tx) and torch.equal(back[1], ty)


def test_build_tables_edge_groups():
    """Cancelling, repeated and identity points: the plain tables equal the
    JAX package's limb for limb (the same 64-point shape as above, one JAX
    compile) and every entry equals the host's subset sum, the identity as
    the (0, 0) marker."""
    groups = edge_groups()
    pts = [p for g in groups for p in g]
    jpts = jg1.points_to_device(jax_points(pts))
    want = tuple(np.asarray(t) for t in jmf._build_tables(*jpts))
    got = msm_fixed.build_tables_plain(*g1_vec.points_to_device(pts, "cpu"))
    for g, w in zip(convert.tables_to_numpy(got), want):
        assert np.array_equal(g, w.astype(np.uint32))
    tx, ty = msm_fixed.unpack_tables(got)
    xs, ys = (g1_vec.FQ.unpack_mont(t.reshape(24, -1)) for t in (tx, ty))
    for gi, group in enumerate(groups):
        sums = [group[0] - group[0]]
        for idx in range(1, 256):
            msb = idx.bit_length() - 1
            sums.append(sums[idx - (1 << msb)] + group[msb])
        for idx, s in enumerate(sums):
            a = s.to_affine()
            assert (xs[gi * 256 + idx], ys[gi * 256 + idx]) == (a or (0, 0)), (gi, idx)
    assert not got[2].any()  # a group of identities: every entry the marker
