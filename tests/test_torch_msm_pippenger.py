"""The port's sorted-bucket Pippenger MSM (plain CPU path) against the JAX
package's ``ops.msm_pippenger.msm_pippenger`` on the same numpy-seeded
inputs and against the exact host MSM. The segmented scan's result depends
on the order inside a run only limb for limb, not as a point, so the
packages are compared as affine points. Tolerance: exact (integers)."""
import jax.numpy as jnp
import pytest

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm_pippenger as jpip
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.curves import msm_host
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, msm_pippenger
from baby_plonk_tpu_torch.ops.limbs import FR

from torch_port_util import field_ints, g1_points, one_torch_thread  # noqa: F401  (fixture)


def _jax_pippenger(tpts, tsc, c):
    out = jpip.msm_pippenger(
        tuple(jnp.asarray(a) for a in convert.srs_to_numpy(tpts)), jnp.asarray(convert.to_numpy(tsc)), c=c
    )
    return jg1.point_from_device(out).to_affine()


@pytest.mark.parametrize("n, c", [(8, 4), (32, 8)])
def test_pippenger_matches_jax_and_host(n, c):
    pts = g1_points(110 + n, n)
    scalars = field_ints(111 + n, fr.Q, n)
    scalars[0], scalars[1] = 0, fr.Q - 1  # the top window takes the masked limb past limb 15
    tpts, tsc = g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")
    got = g1_vec.point_from_device(msm_pippenger.msm_pippenger(tpts, tsc, c=c))
    assert got == msm_host.msm(pts, scalars)
    assert got.to_affine() == _jax_pippenger(tpts, tsc, c)


def test_pippenger_duplicate_digits():
    """Many equal digits: long runs in the segmented scan."""
    n = 16
    pts = [G1.generator() * (i + 1) for i in range(n)]
    scalars = [5] * 8 + [(5 << 8) | 5] * 8
    tpts, tsc = g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")
    got = g1_vec.point_from_device(msm_pippenger.msm_pippenger(tpts, tsc, c=8))
    assert got == msm_host.msm(pts, scalars)


def test_pippenger_ragged_n_and_identity_point():
    """n = 11 is no power of two (the scan's last pass reaches past the
    front); one point is the identity. Against the host oracle only: each
    new (n, c) costs the JAX function a minute of compilation on a CPU."""
    pts = g1_points(130, 11)
    pts[4] = G1.identity()
    scalars = field_ints(131, fr.Q, 11)
    tpts, tsc = g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")
    got = g1_vec.point_from_device(msm_pippenger.msm_pippenger(tpts, tsc, c=6))
    assert got == msm_host.msm(pts, scalars)


def test_window_digits_straddle_limbs():
    """Digits of a window that crosses a 16-bit limb, and of the top window
    (the limb past limb 15 reads as zero)."""
    scalars = [fr.Q - 1, 0x1234_5678_9ABC_DEF0, 1 << 254]
    tsc = FR.pack_raw(scalars, "cpu")
    for c in (5, 12, 14):
        nwin = (255 + c - 1) // c
        for w in (0, 1, nwin - 1):
            want = [(s >> (w * c)) & ((1 << c) - 1) for s in scalars]
            assert msm_pippenger._window_digits(tsc, w, c).tolist() == want


def test_window_c_thresholds():
    assert [msm_pippenger.window_c(n) for n in (1, 1023, 1024, 65535, 65536, 1 << 20)] == [
        jpip.window_c(n) for n in (1, 1023, 1024, 65535, 65536, 1 << 20)]
