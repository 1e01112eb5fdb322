"""Port fixed-base MSM (plain CPU path) against the JAX package's
_msm_fixed_kernel_oh and the exact host MSM on the same points and
scalars."""
import jax.numpy as jnp
import numpy as np

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm_fixed as jmf
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.curves import msm_host
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, msm_fixed
from baby_plonk_tpu_torch.ops.limbs import FR

from torch_port_util import field_ints, g1_points, one_torch_thread  # noqa: F401  (fixture)


def test_msm_matches_jax_onehot_and_host():
    pts = g1_points(12, 64)
    scalars = field_ints(13, fr.Q, 64)
    scalars[0], scalars[9] = 0, 1
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=64)
    got = g1_vec.point_from_device(tabs.msm(FR.pack_raw(scalars, "cpu")))
    assert got == msm_host.msm(pts, scalars)
    # the JAX default commit kernel on the port's own tables
    tx, ty = (jnp.asarray(t) for t in convert.tables_to_numpy(tabs.tables()))
    t_oh = jnp.swapaxes(jnp.concatenate([tx, ty], axis=0), 1, 2)  # (48, 256, G)
    want = jmf._msm_fixed_kernel_oh(t_oh, jnp.asarray(np.asarray(
        [[s >> (16 * i) & 0xFFFF for s in scalars] for i in range(16)], dtype=np.uint32)))
    assert jg1.point_from_device(want).to_affine() == got.to_affine()


def test_msm_many_chunks_and_prefixes():
    """Several scalar sets of different lengths over 3 ragged chunks (the
    chunk combine pads to 4 with the identity)."""
    pts = g1_points(14, 40)
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=16)
    sets = [field_ints(15 + k, fr.Q, k) for k in (40, 17, 1)]
    out = tabs.msm_many([FR.pack_raw(s, "cpu") for s in sets])
    assert g1_vec.points_from_device(out) == [msm_host.msm(pts[: len(s)], s) for s in sets]
