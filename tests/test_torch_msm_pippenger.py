"""The port's sorted-bucket Pippenger MSM (plain CPU path) against the JAX
package's ``ops.msm_pippenger.msm_pippenger`` on the same numpy-seeded
inputs and against the exact host MSM, on random and skewed inputs under
small plans (chunks of 4 to 6 points, joins of 4 and 8 partials, segments
of 1 to 8 buckets), so that the chunks, the join levels and the segments
split at n <= 32. The two packages add in different orders (the port's
chunks, segments and trees against the JAX scans), so they agree as points,
not limb for limb: they are compared as affine points. The JAX function is
compiled at (n, c) = (8, 4) and (32, 8) only: each new shape costs it about
a minute of compilation on a CPU. The stages (bucket sums, window totals)
are held against the JAX package's in test_torch_pippenger_stages.py.
Tolerance: exact (integers)."""
import jax.numpy as jnp
import pytest
import torch

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


def test_window_digits_all_windows():
    """The (nwin, n) digit tensor the sort takes is every window's
    ``_window_digits`` row."""
    tsc = FR.pack_raw(field_ints(140, fr.Q, 9) + [fr.Q - 1], "cpu")
    for c in (1, 4, 13, 14, 16):
        got = msm_pippenger.window_digits(tsc, c)
        assert got.shape == (msm_pippenger.windows(c), 10)
        for w in range(got.shape[0]):
            assert torch.equal(got[w], msm_pippenger._window_digits(tsc, w, c))


def test_window_c_thresholds():
    assert [msm_pippenger.window_c(n) for n in (1, 1023, 1024, 65535, 65536, 1 << 20)] == [
        jpip.window_c(n) for n in (1, 1023, 1024, 65535, 65536, 1 << 20)]


# -- skewed inputs and the plan ---------------------------------------------------


def _skewed(case, n):
    """(points, scalars) of one skewed input of n points."""
    pts = g1_points(160 + n, n)
    rnd = field_ints(161 + n, fr.Q, n)
    if case == "all_equal":
        return pts, [rnd[0]] * n
    if case == "all_zero":
        return pts, [0] * n
    if case == "r_minus_1":
        return pts, [fr.Q - 1] * n
    if case == "identity_points":
        for i in (0, 5, 6, n - 1):
            pts[i] = G1.identity()
        return pts, rnd
    if case == "run_over_three_chunks":
        return pts, rnd[:11] + [rnd[11]] * 10 + rnd[21:]
    return pts, rnd  # "ragged": n no multiple of the chunk


#: (input, n, c, plan (K, JOIN_K, L, BS)) at the two shapes the JAX function
#: is compiled at: chunks of 4 (a run of 10 equal scalars crosses three of
#: them), 5 and 6 (no divisor of n), joins of 4 and 8 partials, segments of
#: 1 to 8 buckets, blocks of 2 to 16 segments
SKEWED = [
    ("all_equal", 8, 4, (4, 4, 2, 8)),
    ("all_zero", 8, 4, (4, 4, 4, 4)),
    ("r_minus_1", 8, 4, (5, 8, 8, 2)),
    ("identity_points", 8, 4, (6, 4, 2, 2)),
    ("ragged", 8, 4, (5, 4, 1, 4)),
    ("run_over_three_chunks", 32, 8, (4, 4, 4, 16)),
]


@pytest.mark.parametrize("case, n, c, plan", SKEWED, ids=[s[0] for s in SKEWED])
def test_pippenger_skewed_inputs(case, n, c, plan):
    """The whole plain MSM under small plans against the host MSM and the
    JAX ``msm_pippenger``."""
    pts, scalars = _skewed(case, n)
    tpts, tsc = g1_vec.points_to_device(pts, "cpu"), FR.pack_raw(scalars, "cpu")
    got = g1_vec.point_from_device(msm_pippenger.msm_pippenger(tpts, tsc, c=c, plan=plan))
    assert got == msm_host.msm(pts, scalars)
    assert got.to_affine() == _jax_pippenger(tpts, tsc, c)


def test_plan_levels_and_rules():
    """The card's plans pass the kernel's rules; each walk level shrinks to
    one chunk a window; the rules refuse what the kernels do not take."""
    for n in (1, 5, 1 << 10, (1 << 14), (1 << 16) + 2, (1 << 16) + 6, 1 << 20):
        c = msm_pippenger.window_c(n)
        plan = msm_pippenger.make_plan(n, c)
        msm_pippenger._check_plan(c, plan)
        lv = msm_pippenger.levels(n, plan[0], plan[1])
        assert lv[0] == (n, plan[0]) and lv[-1][0] <= lv[-1][1]
        assert all(b[0] == 2 * -(-a[0] // a[1]) < a[0] for a, b in zip(lv, lv[1:]))
    # 65,538 points at c = 14 on 132 SMs: chunks that fill the card once
    assert msm_pippenger.make_plan((1 << 16) + 2, 14) == (37, 8, 16, 128)
    for c, plan in ((8, (3, 8, 4, 16)), (8, (4, 2, 4, 16)), (8, (4, 8, 3, 16)), (8, (4, 8, 4, 256)),
                    (4, (4, 8, 2, 16)), (17, (4, 8, 4, 16)), (16, (4, 8, 1, 128))):
        with pytest.raises(ValueError):
            msm_pippenger._check_plan(c, plan)
