"""Variable-base multi-scalar multiplication on the device (counterpart of
``baby_plonk_tpu/ops/msm.py`` and of the fused Pallas MSM,
``ops/pallas_kernels.py::msm_pallas_partials`` :107 / ``msm_pallas`` :159).

Bit-serial double-and-add: every lane runs 255 LSB-first steps
``acc = bit ? acc + base : acc; base = 2 base`` with the complete formulas,
the lanes of a tile are summed by a halving tree, and the per-tile partials
are tree-reduced (``g1_vec.combine_partials``). One launch covers an MSM of
any length: nothing is padded to a power of two or cut into chunks. One formulation stands for
both JAX forms (the Pallas tile kernel and the XLA ``_msm_kernel``, :28-51):
they compute the same point in a different addition order, so the port
equals them as an affine point and equals its own plain version limb for
limb.

Layouts (limb-major, batch last): points (24, n) x3 Montgomery projective,
scalars (16, n) raw (non-Montgomery) 16-bit limbs.

Kernel: ``bpt_msm_bitserial`` (csrc/msm.cu), wrapped by ``msm_partials``
beside its plain version ``msm_partials_plain``.
"""
from __future__ import annotations

import torch

from ..fields import fr
from . import g1_vec, kernels, limbs

#: steps of the bit loop (bit 255 of a canonical Fr scalar is 0)
BITS = 255
#: lanes of one tile = threads of one block. 128 lets two to four blocks share
#: an SM whatever the registers a lane takes, and 65,542 points are then 513
#: blocks on the card's 132 SMs in one launch.
TILE = 128


def _tile_of(n: int, tile: int | None) -> int:
    """The tile a launch over n lanes uses: ``tile`` (default ``TILE``; a
    power of two, at most 256), or the smallest power of two that holds all
    n lanes."""
    tile = TILE if tile is None else tile
    if tile < 1 or tile & (tile - 1) or tile > 256:
        raise ValueError(f"msm_partials: tile {tile} must be a power of two, at most 256")
    if n < 1:
        raise ValueError("msm_partials: no points")
    while tile // 2 >= n:
        tile //= 2
    return tile


def msm_partials_plain(points, scalars, tile: int | None = None):
    """Plain version of ``msm_partials``: 255 full-width steps of
    ``padd_plain`` / ``pdouble_plain`` / ``where`` on int64 limbs, then the
    in-tile halving tree (lane i takes lane i + half). A ragged last tile is
    filled with zero scalars, whose lanes keep the identity. Returns int64
    (24, ceil(n / tile)) x3."""
    n = points[0].shape[-1]
    t = _tile_of(n, tile)
    tiles = -(-n // t)
    pad = tiles * t - n
    sc = scalars.to(torch.int64)
    base = g1_vec._to64(points)
    if pad:
        base = tuple(torch.cat([c, c[:, :1].expand(24, pad)], dim=-1) for c in base)
        sc = torch.cat([sc, sc.new_zeros((16, pad))], dim=-1)
    acc = g1_vec.pidentity((tiles * t,), scalars.device, torch.int64)
    for bit in range(BITS):
        set_ = ((sc[bit >> 4] >> (bit & 15)) & 1) == 1
        acc = g1_vec.pselect(set_, g1_vec.padd_plain(acc, base), acc)
        if bit + 1 < BITS:
            base = g1_vec.pdouble_plain(base)
    acc = tuple(c.reshape(24, tiles, t) for c in acc)
    m = t
    while m > 1:
        half = m // 2
        acc = g1_vec.padd_plain(
            tuple(c[..., :half] for c in acc), tuple(c[..., half:m] for c in acc)
        )
        m = half
    return tuple(c[..., 0] for c in acc)


def msm_partials(points, scalars, tile: int | None = None):
    """(24, n) x3 points + (16, n) raw scalars -> (24, ceil(n / tile)) x3
    partial sums, one per tile of ``tile`` lanes (a power of two, at most
    256; a smaller power of two where that holds all n), in one launch.
    n need be no multiple of the tile."""
    if kernels.on_cpu(*points, scalars):
        return g1_vec._to32(msm_partials_plain(points, scalars, tile))
    dev = kernels.check_cuda(*points, scalars)
    n = scalars.shape[-1]
    if scalars.shape != (16, n) or any(c.shape != (24, n) for c in points):
        raise ValueError("msm_partials: points must be (24, n) x3 and scalars (16, n)")
    t = _tile_of(n, tile)
    points = tuple(c.contiguous() for c in points)
    scalars = scalars.contiguous()
    out = tuple(torch.empty((24, -(-n // t)), dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("bpt_msm_bitserial", dev, *(kernels.ptr(c) for c in points), kernels.ptr(scalars),
                   n, t, *(kernels.ptr(c) for c in out))
    msm_partials.launches += 1
    return out


msm_partials.launches = 0


def msm_bitserial(points, scalars, tile: int | None = None):
    """Full bit-serial MSM: the tile kernel over all n points in one launch,
    then the cross-tile reduction. Returns (X, Y, Z) limb vectors (24,)."""
    return g1_vec.combine_partials(msm_partials(points, scalars, tile))


def msm_device_arrays(points, scalars):
    """Device MSM over packed tensors, by the algorithm the config selects
    (``bitserial`` | ``pippenger``). Returns (X, Y, Z) (24,)."""
    from ..config import get_config

    algorithm = get_config().msm_algorithm
    if algorithm == "pippenger":
        from . import msm_pippenger

        return msm_pippenger.msm_pippenger(points, scalars)
    if algorithm != "bitserial":
        raise ValueError(f"unknown msm_algorithm {algorithm!r}: expected 'bitserial' or 'pippenger'")
    return msm_bitserial(points, scalars)


def msm(points, scalars, device="cuda"):
    """Host boundary: list[G1] x list[int] -> host G1 (identity for n = 0)."""
    from ..curves.g1 import G1

    n = min(len(points), len(scalars))
    if n == 0:
        return G1.identity()
    pts = g1_vec.points_to_device(points[:n], device)
    sc = limbs.FR.pack_raw([s % fr.Q for s in scalars[:n]], device)
    return g1_vec.point_from_device(msm_device_arrays(pts, sc))
