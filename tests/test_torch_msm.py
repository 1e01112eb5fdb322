"""The port's variable-base MSM (plain CPU path) against the JAX package's
``ops.msm.msm_device_arrays`` on the same numpy-seeded points and scalars,
and against the exact host MSM. The two packages add in a different order,
so they are compared as affine points. Tolerance: exact (integers)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm as jmsm
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.curves import msm_host
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, msm
from baby_plonk_tpu_torch.ops.limbs import FR

from torch_port_util import field_ints, g1_points, one_torch_thread  # noqa: F401  (fixture)


def _inputs(seed: int, n: int):
    """Host points and scalars, and the port's tensors of both."""
    pts = g1_points(seed, n)
    scalars = field_ints(seed + 1, fr.Q, n)
    return pts, scalars, g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")


def _jax_msm(tpts, tsc):
    """The JAX package's MSM of the port's limb arrays, as an affine pair."""
    out = jmsm.msm_device_arrays(
        tuple(jnp.asarray(c) for c in convert.srs_to_numpy(tpts)), jnp.asarray(convert.to_numpy(tsc))
    )
    return jg1.point_from_device(out).to_affine()


@pytest.mark.parametrize("n", [1, 5, 16])
def test_msm_device_arrays_matches_jax_and_host(n):
    pts, scalars, tpts, tsc = _inputs(50 + n, n)
    got = g1_vec.point_from_device(msm.msm_device_arrays(tpts, tsc))
    assert got == msm_host.msm(pts, scalars)
    assert got.to_affine() == _jax_msm(tpts, tsc)


def test_chunked_msm_matches_jax_and_host(monkeypatch):
    """n = 10 pads to 16 and runs 4 chunks of 4 in both packages."""
    monkeypatch.setattr(msm, "CHUNK", 4)
    monkeypatch.setattr(jmsm, "CHUNK", 4)
    pts, scalars, tpts, tsc = _inputs(70, 10)
    got = g1_vec.point_from_device(msm.msm_device_arrays(tpts, tsc))
    assert got == msm_host.msm(pts, scalars)
    assert got.to_affine() == _jax_msm(tpts, tsc)


def test_partials_plain_tile_8_matches_host():
    """One partial per tile of 8 lanes, each the host MSM of its tile; with a
    zero scalar, Q - 1, and the identity among the points."""
    pts, scalars, _, _ = _inputs(80, 16)
    scalars[0], scalars[3], pts[5] = 0, fr.Q - 1, G1.identity()
    tpts, tsc = g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")
    part = msm.msm_partials_plain(tpts, tsc, tile=8)
    assert part[0].shape == (24, 2) and part[0].dtype == torch.int64
    assert g1_vec.points_from_device(part) == [
        msm_host.msm(pts[i : i + 8], scalars[i : i + 8]) for i in (0, 8)
    ]
    # the wrapper takes the plain version for CPU tensors
    assert all(torch.equal(a.long(), b) for a, b in zip(msm.msm_partials(tpts, tsc, tile=8), part))
    assert g1_vec.point_from_device(msm.msm_bitserial(tpts, tsc, tile=8)) == msm_host.msm(pts, scalars)


def test_zero_scalars_and_empty():
    pts = g1_points(90, 4)
    tpts = g1_vec.points_to_device(pts, "cpu")
    zero = FR.pack_raw([0] * 4, "cpu")
    assert g1_vec.point_from_device(msm.msm_device_arrays(tpts, zero)).is_identity()
    assert msm.msm([], [], "cpu").is_identity()
    assert msm.msm(pts, [1, 0, 0, fr.Q - 1], "cpu") == pts[0] - pts[3]


def test_partials_reject_ragged_tile():
    _, _, tpts, tsc = _inputs(95, 6)
    with pytest.raises(ValueError):
        msm.msm_partials(tpts, tsc, tile=4)


@pytest.mark.slow
def test_partials_match_pallas_interpret():
    """The fused Pallas MSM in interpret mode (minutes) at tile 8."""
    from baby_plonk_tpu.ops import pallas_kernels

    _, _, tpts, tsc = _inputs(97, 16)
    want = pallas_kernels.msm_pallas(
        tuple(jnp.asarray(c) for c in convert.srs_to_numpy(tpts)),
        jnp.asarray(convert.to_numpy(tsc)), tile=8,
    )
    got = g1_vec.point_from_device(msm.msm_bitserial(tpts, tsc, tile=8))
    assert got.to_affine() == jg1.point_from_device(want).to_affine()
    # same addition order inside and across tiles: equal limb for limb
    for g, w in zip(convert.srs_to_numpy(msm.msm_bitserial(tpts, tsc, tile=8)), want):
        assert np.array_equal(g, np.asarray(w))
