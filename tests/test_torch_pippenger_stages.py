"""The stages of the port's Pippenger MSM (plain CPU path) against the JAX
package's on the same numpy-seeded input: each window's bucket sums (the
port's chunk walk and join levels) against the JAX segmented scan
(``_segmented_sum``) and its searchsorted bucket table, and each window's
total sum_d d B_d (the port's segments, shifts and trees) against
``_bucket_suffix_total`` on the same bucket table, at c = 4 and 8. The two
packages add in different orders, so they are compared as affine points.
The JAX stages are one jit(vmap over windows) a width (about half a minute
of compilation each on a CPU). Tolerance: exact (integers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm_pippenger as jpip
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, msm_pippenger
from baby_plonk_tpu_torch.ops.limbs import FR

from torch_port_util import field_ints, g1_points, one_torch_thread  # noqa: F401  (fixture)

N = 32


def _jax_windows(c):
    """jit(vmap over windows) of the JAX function's per-window stages: the
    bucket table from the sorted digits (argsort, ``_segmented_sum``, the
    searchsorted run ends, identity where a digit has no point) and its
    ``_bucket_suffix_total``."""
    nb = 1 << c

    def one(px, py, pz, d):
        order = jnp.argsort(d)
        ds = jnp.take(d, order)
        ps = jpip._segmented_sum(tuple(jnp.take(q, order, axis=-1) for q in (px, py, pz)), ds)
        idx_b = jnp.arange(nb, dtype=jnp.int32)
        pos = jnp.searchsorted(ds, idx_b, side="right") - 1
        pos_c = jnp.clip(pos, 0, d.shape[0] - 1)
        found = (pos >= 0) & (jnp.take(ds, pos_c) == idx_b)
        bucket = jg1.pselect(found, tuple(jnp.take(q, pos_c, axis=-1) for q in ps), jg1.pidentity((nb,)))
        return bucket, jpip._bucket_suffix_total(bucket, c)

    return jax.jit(jax.vmap(one, in_axes=(None, None, None, 0)))


def _affine_lanes(p):
    """(24, ...) x3 limb tensors (or JAX arrays) -> affine values, lane order."""
    flat = tuple(torch.from_numpy(np.asarray(q).astype(np.int32)).reshape(24, -1) for q in p)
    return [q.to_affine() for q in g1_vec.points_from_device(flat)]


def _present_or_identity(p, present):
    ident = g1_vec.pidentity(present.shape, "cpu", torch.int64)
    return tuple(torch.where(present, q, e) for q, e in zip(p, ident))


#: (c, plan (K, JOIN_K, L, BS)) of the stage tests: chunks of 4 and 5 points
#: split n = 32, joins of 4 partials, segments of 2 and 4 buckets, trees of
#: 4 and 16 segments a block and several blocks a window
STAGES = [(4, (4, 4, 2, 4)), (8, (5, 4, 4, 16))]


@pytest.fixture(scope="module", params=STAGES, ids=["c4", "c8"])
def stages(request):
    """One numpy-seeded input (runs of equal scalars included) through the
    JAX stages and the port's plain bucket walk."""
    c, plan = request.param
    pts = g1_points(150, N)
    scalars = field_ints(151, fr.Q, N)
    scalars[3:13] = [scalars[3]] * 10  # one run across three chunks in every window
    scalars[20] = 0
    tpts, tsc = g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")
    digits = msm_pippenger.window_digits(tsc, c)
    jbucket, jtotal = _jax_windows(c)(
        *(jnp.asarray(a) for a in convert.srs_to_numpy(tpts)), jnp.asarray(digits.numpy().astype(np.int32)))
    ds, order = msm_pippenger.sorted_digits(tsc, c)
    bucket, present = msm_pippenger.bucket_sums_plain(tpts, ds, order, plan[0], plan[1], c)
    return c, plan, digits, jbucket, jtotal, bucket, present


def test_bucket_sums_match_jax(stages):
    """Every bucket d >= 1 of every window: the plain walk's sum (identity
    where no point has the digit) equals the JAX bucket table's entry."""
    c, _, digits, jbucket, _, bucket, present = stages
    nwin, nb = present.shape
    assert not present[:, 0].any(), "digit 0 has no bucket"
    for w in range(nwin):
        assert present[w].tolist() == [d > 0 and d in set(digits[w].tolist()) for d in range(nb)]
    got = _affine_lanes(tuple(q[:, :, 1:] for q in _present_or_identity(bucket, present)))
    want = _affine_lanes(tuple(jnp.moveaxis(q, 0, 1)[:, :, 1:] for q in jbucket))
    assert got == want


def test_window_totals_match_jax(stages):
    """sum_d d B_d of every window from the JAX bucket table: the plain
    segments and trees (present = the table's nonzero digits that hold a
    point) against ``_bucket_suffix_total``."""
    c, plan, digits, jbucket, jtotal, _, _ = stages
    nwin, nb = digits.shape[0], 1 << c
    table = tuple(torch.from_numpy(np.asarray(jnp.moveaxis(q, 0, 1)).astype(np.int64)) for q in jbucket)
    present = torch.tensor([[d > 0 and d in set(digits[w].tolist()) for d in range(nb)] for w in range(nwin)])
    wtot, wflag = msm_pippenger.window_totals_plain(table, present, c, plan[2], plan[3])
    assert wflag.tolist() == present.any(1).tolist()
    got = _affine_lanes(_present_or_identity(wtot, wflag))
    assert got == _affine_lanes(tuple(jnp.moveaxis(q, 0, 1) for q in jtotal))
