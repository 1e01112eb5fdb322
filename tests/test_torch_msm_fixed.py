"""Port fixed-base MSM (plain CPU path) against the JAX package's
_msm_fixed_kernel_oh and the exact host MSM on the same points and
scalars: the unsplit Horner loop, the window split with its join, lanes
that sum K groups a bit, and scalar sets that end inside a group and
inside a chunk. Tolerance: exact (integers; the packages are compared as
affine points)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm_fixed as jmf
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.curves import msm_host
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, msm_fixed
from baby_plonk_tpu_torch.ops.limbs import FR
from baby_plonk_tpu_torch.utils.metrics import get_metrics

from torch_port_util import field_ints, g1_points, one_torch_thread  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def tables64():
    """64 points, their scalars (a zero and a one among them), the port's
    tables over one chunk, and the JAX commit kernel's point on those tables."""
    pts = g1_points(12, 64)
    scalars = field_ints(13, fr.Q, 64)
    scalars[0], scalars[9] = 0, 1
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=64)
    tx, ty = (jnp.asarray(t) for t in convert.tables_to_numpy(tabs.tables()))
    t_oh = jnp.swapaxes(jnp.concatenate([tx, ty], axis=0), 1, 2)  # (48, 256, G)
    want = jmf._msm_fixed_kernel_oh(t_oh, jnp.asarray(np.asarray(
        [[s >> (16 * i) & 0xFFFF for s in scalars] for i in range(16)], dtype=np.uint32)))
    return pts, scalars, tabs, jg1.point_from_device(want).to_affine()


def test_msm_matches_jax_onehot_and_host(tables64):
    pts, scalars, tabs, jax_affine = tables64
    got = g1_vec.point_from_device(tabs.msm(FR.pack_raw(scalars, "cpu")))
    assert got == msm_host.msm(pts, scalars)
    # the JAX default commit kernel on the port's own tables
    assert jax_affine == got.to_affine()


@pytest.mark.parametrize("windows", [1, 3, 5])
def test_window_split_matches_jax_onehot_and_host(tables64, windows):
    """255 bits in W windows of ceil(255 / W) bits (the top one shorter),
    joined by the Horner over the windows."""
    pts, scalars, tabs, jax_affine = tables64
    sc = FR.pack_raw(scalars, "cpu")
    got = g1_vec.point_from_device(tabs.msm(sc, windows=windows))
    assert got == msm_host.msm(pts, scalars)
    assert got.to_affine() == jax_affine
    part = msm_fixed.msm_fixed_horner(tabs.tables(), sc.reshape(16, 1, 64), windows)
    assert part[0].shape == (24, 1, windows, 8)
    # window w of group g alone is the host MSM of the group's scalars' bits [w S, (w + 1) S)
    S = msm_fixed.window_bits(windows)
    w, g = windows - 1, 5
    lane = g1_vec.points_from_device(tuple(c[:, 0, w, g].reshape(24, 1) for c in part))[0]
    cut = [(s >> (w * S)) & ((1 << S) - 1) for s in scalars[8 * g : 8 * g + 8]]
    assert lane == msm_host.msm(pts[8 * g : 8 * g + 8], cut)


def test_join_plain_is_the_horner_over_windows():
    pts = g1_points(31, 6)
    win = tuple(c.reshape(24, 2, 3) for c in g1_vec.points_to_device(pts, "cpu"))
    out = g1_vec.points_from_device(msm_fixed.msm_join(win, 4))
    assert out == [pts[0] + pts[1] * 16 + pts[2] * 256, pts[3] + pts[4] * 16 + pts[5] * 256]
    assert msm_fixed.windows_for(3 * 8193, "cpu") == 1
    with pytest.raises(ValueError):
        msm_fixed.window_bits(0)


def test_msm_many_chunks_and_prefixes():
    """Several scalar sets of different lengths over 3 ragged chunks (the
    chunk combine pads to 4 with the identity)."""
    pts = g1_points(14, 40)
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=16)
    sets = [field_ints(15 + k, fr.Q, k) for k in (40, 17, 1)]
    out = tabs.msm_many([FR.pack_raw(s, "cpu") for s in sets])
    assert g1_vec.points_from_device(out) == [msm_host.msm(pts[: len(s)], s) for s in sets]


@pytest.mark.parametrize("k, groups", [(1, 1), (13, 2), (32, 4), (35, 5), (49, 8), (56, 8)])
def test_launch_is_sized_to_the_scalars(k, groups):
    """Scalar sets that end inside a group (13, 35), on the chunk's edge (32)
    and inside the second chunk (35, 49): the launch covers the whole chunks
    (4 groups each) and the rest rounded up to a power of two of groups (49
    scalars: 3 -> 4), no more; with and without the window split."""
    pts = g1_points(14, 56)
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=32)
    full, rest = tabs.launch_groups(k)
    assert full * 4 + rest == groups
    assert tabs.tables().shape == (8, 256, 24)  # 56 points: a chunk of 4 groups and a rest of 3 -> 4
    scalars = field_ints(40 + k, fr.Q, k)
    want = msm_host.msm(pts[:k], scalars)
    seen = []
    real = msm_fixed.msm_fixed_horner
    try:
        msm_fixed.msm_fixed_horner = lambda t, sc, *rest: seen.append(sc.shape) or real(t, sc, *rest)
        for windows in (1, 2):
            got = tabs.msm(FR.pack_raw(scalars, "cpu"), windows=windows)
            assert g1_vec.point_from_device(got) == want
    finally:
        msm_fixed.msm_fixed_horner = real
    assert seen == [torch.Size((16, 1, 8 * groups))] * 2


@pytest.mark.parametrize("K, chunk_groups", [(2, 3), (3, 4), (3, 8), (8, 3)])
def test_groups_per_lane_sums_slices(tables64, K, chunk_groups):
    """K groups a lane: each slot is the sum of the K = 1 lanes of its
    slice (chunks of 3 or 4 groups that K does not divide, a ragged rest
    of 2, slices of one group fewer), the empty slots the identity, and
    the slots add up to the JAX one-hot kernel's point and the host MSM."""
    pts, scalars, tabs, jax_affine = tables64
    sc = FR.pack_raw(scalars, "cpu").reshape(16, 1, 64)
    one = g1_vec.points_from_device(tuple(c[:, 0, 0] for c in msm_fixed.msm_fixed_plain(tabs.tables(), sc)))
    part = msm_fixed.msm_fixed_plain(tabs.tables(), sc, 1, K, chunk_groups)
    per_chunk, rest = msm_fixed.lane_slots(8, K, chunk_groups)
    assert part[0].shape == (24, 1, 1, 8 // chunk_groups * per_chunk + rest)
    got = g1_vec.points_from_device(tuple(c[:, 0, 0] for c in part))
    first, count, stride = msm_fixed._slot_groups(8, K, chunk_groups, "cpu")
    for slot, (f, n, m) in enumerate(zip(first.tolist(), count.tolist(), stride.tolist())):
        assert got[slot] == sum(one[f : f + n * m : m], G1.identity())
    total = sum(got[1:], got[0])
    assert total == msm_host.msm(pts, scalars)
    assert total.to_affine() == jax_affine


def test_per_chunk_commits_at_k_groups_a_lane(monkeypatch):
    """The commit's chunk trees and per-chunk sums with K forced to 2, 3
    and 8 (the CPU's own choice is 1): 56 points in chunks of 4 groups and
    a rest of 3 rounded to 4; the counters add P G groups and P W L lanes."""
    pts = g1_points(16, 56)
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=32)
    sets = [field_ints(17 + k, fr.Q, k) for k in (56, 30)]
    raw = [FR.pack_raw(s, "cpu") for s in sets]
    m = get_metrics()
    for K in (2, 3, 8):
        monkeypatch.setattr(msm_fixed, "groups_per_lane", lambda P, G, dev, K=K: K)
        before = m.counters["horner_groups"], m.counters["horner_lanes"]
        out = g1_vec.points_from_device(tabs.msm_many(raw))
        assert out == [msm_host.msm(pts[: len(s)], s) for s in sets]
        slices = -(-4 // K)  # a chunk's 4 groups and the rest's 4
        assert (m.counters["horner_groups"] - before[0], m.counters["horner_lanes"] - before[1]) == (2 * 8, 2 * 2 * slices)
        chunks = tabs.msm_many(raw, per_chunk=True)
        assert chunks[0].shape == (24, 2, 2)
        got = g1_vec.points_from_device(tuple(c.reshape(24, 4) for c in chunks))
        for i, s in enumerate(sets):
            padded = s + [0] * (56 - len(s))
            assert got[2 * i : 2 * i + 2] == [msm_host.msm(pts[:32], padded[:32]), msm_host.msm(pts[32:], padded[32:])]


def test_groups_per_lane_from_the_shape():
    """K = 1 on the CPU and wherever the lanes fit the card's resident lanes
    (every 2^16 commit: 8,193 groups, 1-3 sets); over them, the fewest waves
    of 2 blocks an SM times a lane's work a step: 12, 8 and 4 at 2^20
    (131,073 groups, 3, 2, 1 sets) on 132 SMs. The counters of one commit:
    P G groups, P W lanes."""
    for P, K in ((1, 4), (2, 8), (3, 12)):
        assert msm_fixed.groups_per_lane(P, 8193, "cpu") == 1
        assert msm_fixed.groups_per_lane(P, 131073, "cpu") == 1
        assert msm_fixed.lane_groups_for(P * 8193, 132) == 1
        assert msm_fixed.lane_groups_for(P * 131073, 132) == K
        # one wave: the lanes fit 2 blocks of 128 an SM
        assert P * msm_fixed._lanes_run(131073, K, 2048) <= 132 * msm_fixed.SLICED_LANES_PER_SM
    assert msm_fixed.lane_slots(131073, 8, 2048) == (256, 1)
    assert msm_fixed.lane_slots(131073, 12, 2048) == (256, 1)  # 171 slices, rounded for the tree
    assert msm_fixed.lane_slots(8193, 1, 2048) == (2048, 1)
    pts = g1_points(18, 24)  # 3 groups: a chunk of 2 and a rest of 1
    tabs = msm_fixed.FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=16)
    m = get_metrics()
    before = m.counters["horner_groups"], m.counters["horner_lanes"]
    tabs.msm_many([FR.pack_raw(field_ints(19, fr.Q, 24), "cpu")] * 3)
    assert (m.counters["horner_groups"] - before[0], m.counters["horner_lanes"] - before[1]) == (3 * 3, 3 * 3)
