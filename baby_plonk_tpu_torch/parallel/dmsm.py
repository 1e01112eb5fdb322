"""Distributed MSM: points sharded over the mesh, one local MSM a shard,
the D projective partials gathered on ``home`` and added (counterpart of
``baby_plonk_tpu/parallel/dmsm.py``).

Each shard's MSM is the port's own on its block: the bit-serial kernel
(``msm.msm_partials``, tiles that never straddle two blocks) or the
fixed-base Horner kernel over subset-sum tables of its block
(``msm_fixed.FixedBaseTables``, one chunk a block), so each device builds
and holds only its blocks' tables. The shards that share a device run in
one launch, which gives each shard's sum apart. Group addition is not a
ring sum, hence gather and add: ``g1_vec.combine_partials`` pads the D
partials to a power of two with the identity (the JAX package's tree needs
D a power of two).
"""
from __future__ import annotations

import torch

from ..fields import fr
from ..ops import g1_vec, limbs, msm
from ..ops.msm_fixed import GROUP, FixedBaseTables


def _by_device(mesh):
    """[(device, positions in this process's shard lists)], in order of
    first appearance."""
    groups: dict = {}
    for d, dev in enumerate(mesh.devices):
        groups.setdefault(dev, []).append(d)
    return list(groups.items())


def _combine(partials, mesh):
    """This process's partials (24, ...) x3, one a shard, -> the sum of all
    D partials on ``home``: the partials gathered (X, Y, Z in one tensor,
    one collective) and added in every process."""
    stacked = mesh.gather([torch.stack(p)[..., None] for p in partials])  # (3, 24, ..., D)
    return g1_vec.combine_partials(tuple(stacked))


def msm_sharded_arrays(point_shards, scalar_shards, mesh):
    """Bit-serial MSM over the mesh. ``point_shards``: (24, n/D) x3 a shard,
    ``scalar_shards``: (16, n/D) raw limbs a shard, n/D a power of two.
    Returns (24,) x3 on ``home``."""
    partials = [None] * len(mesh.devices)
    for _, idx in _by_device(mesh):
        pts = tuple(torch.cat([point_shards[d][k] for d in idx], dim=-1) for k in range(3))
        sc = torch.cat([scalar_shards[d] for d in idx], dim=-1)
        s = scalar_shards[idx[0]].shape[-1]
        tile = min(msm.TILE, s)  # a power of two dividing the block
        parts = msm.msm_partials(pts, sc, tile=tile)  # (24, blocks x s / tile)
        sums = g1_vec.combine_partials(tuple(c.reshape(24, len(idx), s // tile) for c in parts))
        for j, d in enumerate(idx):
            partials[d] = tuple(c[:, j] for c in sums)
    return _combine(partials, mesh)


def pad_shard_count(n: int, D: int) -> int:
    """The least D 2^k at or above n: every shard a power of two."""
    shard = 1
    while shard * D < n:
        shard <<= 1
    return shard * D


def msm_sharded(points, scalars, mesh):
    """Host boundary: list[G1] x list[int] -> host G1, sharded over the
    mesh; n is padded to D 2^k with copies of point 0 and zero scalars."""
    n = min(len(points), len(scalars))
    total = pad_shard_count(n, mesh.D)
    pts = list(points[:n]) + [points[0]] * (total - n)
    sc = [s % fr.Q for s in scalars[:n]] + [0] * (total - n)
    arr = g1_vec.points_to_device(pts, mesh.home)
    point_shards = list(zip(*(mesh.shard(c) for c in arr)))
    out = msm_sharded_arrays(point_shards, mesh.shard(limbs.FR.pack_raw(sc, mesh.home)), mesh)
    return g1_vec.point_from_device(out)


def build_tables_sharded(point_shards, mesh):
    """The subset-sum tables of every shard's block of points, built and
    held on its device: one ``FixedBaseTables`` a device over the blocks of
    the shards it holds, one chunk a block, so one Horner launch a device
    gives each shard's sum apart. A block must be a power of two of 8-point
    groups (the chunk's rule). Returns [(shard indices, tables)]."""
    out = []
    for dev, idx in _by_device(mesh):
        pts = tuple(torch.cat([point_shards[d][k] for d in idx], dim=-1) for k in range(3))
        n = point_shards[idx[0]][0].shape[-1]
        if n % GROUP or (n // GROUP) & (n // GROUP - 1):
            raise ValueError(f"fixed-base tables: shard of {n} points, not a power of two of {GROUP}-point groups")
        t = FixedBaseTables(pts, chunk=n)
        t.tables()
        out.append((idx, t))
    return out


def msm_fixed_sharded(tables, scalar_shards, mesh):
    """Fixed-base MSMs over the mesh: ``scalar_shards[d]`` is the list of P
    raw scalar blocks (16, n/D) of shard d, against ``build_tables_sharded``'s
    tables. Each shard's partial comes out of its device's launch apart, and
    the D partials are added on ``home``. Returns (24, P) x3."""
    partials = [None] * len(mesh.devices)
    for idx, t in tables:
        P = len(scalar_shards[idx[0]])
        sc = [torch.cat([scalar_shards[d][i] for d in idx], dim=-1) for i in range(P)]
        out = t.msm_many(sc, per_chunk=True)  # (24, P, shards on the device)
        for j, d in enumerate(idx):
            partials[d] = tuple(c[..., j] for c in out)
    return _combine(partials, mesh)
