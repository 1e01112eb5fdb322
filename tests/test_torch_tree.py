"""The port's group tree (``g1_vec.tree_reduce``, the plain path on CPU
tensors) against the JAX package's ``g1_vec.tree_reduce`` under jax.jit on
the same seeded points, limb for limb in X, Y and Z, with identity lanes and
equal points (the doubling case of the complete addition);
``combine_partials`` against ``msm._combine_partials``; the refusal of a
lane count that is no power of two; and the launch plan and view layout that
the card's kernel (csrc/g1.cu, ``bpt_g1_tree``) is given. Exact: the
arithmetic is modular, nothing rounds."""
import math

import jax
import numpy as np
import pytest
import torch

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.ops import msm as jmsm
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.ops import g1_vec

from torch_port_util import g1_points, jax_points, one_torch_thread  # noqa: F401  (fixture)


def _lane_points(seed: int, sets: int, n: int) -> list:
    """sets x n host points, set-major, drawn from ``seed``; in every set of
    8 lanes or more: lane n/2 equals lane 0 and lane 3n/4 equals lane n/4
    (equal points at the first and the second level), lane 1 is the
    identity and lane 1 + n/2 the negation of lane 2 + n/2."""
    pts = g1_points(seed, sets * n)
    for s in range(0, len(pts), n):
        if n >= 8:
            pts[s + n // 2] = pts[s]
            pts[s + 3 * n // 4] = pts[s + n // 4]
            pts[s + 1] = G1.identity()
            pts[s + 1 + n // 2] = -pts[s + 2 + n // 2]
    return pts


def _both(pts: list, shape: tuple):
    """The same points as the port's CPU tensors and the JAX package's
    arrays, each coordinate (24, *shape)."""
    port = tuple(c.reshape((24,) + shape) for c in g1_vec.points_to_device(pts, "cpu"))
    ref = tuple(c.reshape((24,) + shape) for c in jg1.points_to_device(jax_points(pts)))
    return port, ref


def _assert_limbs_equal(port, ref):
    for t, j in zip(port, ref):
        j = np.asarray(j).astype(np.int64)
        assert t.shape == j.shape
        assert np.array_equal(t.numpy().astype(np.int64), j)


def _host_sums(pts: list, n: int) -> list:
    out = []
    for s in range(0, len(pts), n):
        total = G1.identity()
        for p in pts[s : s + n]:
            total = total + p
        out.append(total)
    return out


@pytest.mark.parametrize("shape", [(16,), (2, 3, 8), (1,)], ids=["24x16", "24x2x3x8", "24x1"])
def test_tree_reduce_matches_jax_limb_for_limb(shape):
    n, sets = shape[-1], math.prod(shape[:-1])
    pts = _lane_points(31 + n, sets, n)
    port, ref = _both(pts, shape)
    got = g1_vec.tree_reduce(port)
    _assert_limbs_equal(got, jax.jit(jg1.tree_reduce)(ref))
    assert g1_vec.points_from_device(got) == _host_sums(pts, n)


def test_combine_partials_five_matches_jax():
    pts = g1_points(41, 4) + [G1.identity()]
    port, ref = _both(pts, (5,))
    got = g1_vec.combine_partials(port)
    _assert_limbs_equal(got, jmsm._combine_partials(ref))
    assert g1_vec.point_from_device(got) == _host_sums(pts, 5)[0]


def test_tree_reduce_refuses_six_lanes():
    port, _ = _both(g1_points(43, 6), (6,))
    with pytest.raises(ValueError, match="power of two"):
        g1_vec.tree_reduce(port)
    with pytest.raises(ValueError, match="power of two"):
        g1_vec.tree_reduce_plain(port)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 512, 1024, 2048, 1 << 14, 1 << 18])
@pytest.mark.parametrize("sets", [1, 6, 24, 1000])
def test_tree_plan(n, sets):
    """Every launch fits the kernel's blocks: n / B lanes and the last
    block's B points at two a thread, at most TREE_THREADS threads; the
    blocks fill the card's SMs unless a set is cut down to a warp's lanes."""
    sms = 132
    B, units = g1_vec.tree_plan(n, sets, sms)
    m = n // B
    assert B & (B - 1) == 0 and m * B == n
    threads = units * max(m // 2, 1) if B == 1 else max(m // 2, B // 2)
    assert 1 <= threads <= g1_vec.TREE_THREADS
    assert units == 1 or B == 1
    assert sets * B >= sms or m <= g1_vec.TREE_MIN_LANES
    assert units <= sets


def test_tree_plan_main_path_and_limit():
    # the fixed-base commit's 4 chunks of 2048 groups at 3 sets and 2 windows:
    # 8 blocks of 128 threads a set; the chunk combine (24, 3, 2, 8): one block
    assert g1_vec.tree_plan(2048, 24, 132) == (8, 1)
    assert g1_vec.tree_plan(8, 6, 132) == (1, 6)
    with pytest.raises(ValueError, match="more than one launch"):
        g1_vec.tree_plan(1 << 19, 1, 132)


def test_tree_layout_reads_the_callers_view():
    """The strides the kernel is given put every element where the view
    has it: the fixed-base MSM's (24, P, W, full, chunk) view of the first
    full chunks of its (24, P, W, G) partials folds into two set strides
    (no copy); a batch whose axes do not fold gives None (one copy)."""
    part = torch.arange(24 * 3 * 2 * 33, dtype=torch.int32).reshape(24, 3, 2, 33)
    views = [part[..., :32].reshape(24, 3, 2, 4, 8), part[..., 32:], part, part[:, 1, :, :16]]
    for v in views:
        limb, lane, inner, outer_stride, inner_stride = g1_vec.tree_layout(v)
        n, sets = v.shape[-1], math.prod(v.shape[1:-1])
        rebuilt = torch.as_strided(v, (24, sets // inner, inner, n), (limb, outer_stride, inner_stride, lane),
                                   v.storage_offset())
        assert torch.equal(rebuilt.reshape(24, sets, n), v.reshape(24, sets, n))
    assert g1_vec.tree_layout(views[0])[2] == 4  # (P, W) fold; full is the inner axis
    assert g1_vec.tree_layout(part.permute(0, 2, 1, 3)[..., :32].reshape(24, 2, 3, 4, 8)) is None
