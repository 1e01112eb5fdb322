"""Distributed prefix and suffix products, and the round-2 grand product
(counterpart of ``baby_plonk_tpu/parallel/dscan.py``).

The engine's grand product (``TorchEngine._grand_product``) is
z_i = (f_0 .. f_{i-1}) (g_i .. g_{n-1}) / (g_0 .. g_{n-1}): an exclusive
prefix product of f and an inclusive suffix product of g, one scan each,
and one inversion. Over the mesh each shard scans its own block
(``limbs.field_scan``, which also gives the block's total), the D totals
are all-gathered (16 x D words), and each shard folds in the totals of the
lower-ranked shards (the prefix) or of the higher-ranked ones (the
suffix). The whole product of g is the fold of all D totals: one
``limbs.mont_pow_fixed`` inverts it.
"""
from __future__ import annotations

import torch

from ..fields import fr
from ..ops import limbs
from ..ops.limbs import FR
from ..ops.prover_kernels import grand_product_fg

Q = fr.Q


def _mm(a, b):
    return limbs.mont_mul(FR, a, b)


def _product(x: torch.Tensor) -> torch.Tensor:
    """Product of the columns of (16, k), (16, 1): a halving product over
    k padded to a power of two with Montgomery ones (k = 0 gives one), so a
    shard count that is no power of two loses no column."""
    k = x.shape[-1]
    width = 1
    while width < k:
        width <<= 1
    if width != k:
        x = torch.cat([x, FR.one(x.device).expand(16, width - k).to(x.dtype)], dim=-1)
    while width > 1:
        width //= 2
        x = _mm(x[:, :width], x[:, width:])
    return x


def _fold_totals(scan, totals: torch.Tensor, d: int, reverse: bool) -> torch.Tensor:
    """Shard d's local scan times the product of the totals of the shards
    before it (after it for ``reverse``). ``totals``: (16, D), every shard's
    total, on shard d's device."""
    other = totals[:, d + 1 :] if reverse else totals[:, :d]
    return _mm(scan, _product(other))


def grand_product_part1(a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2, mesh):
    """Shard lists (16, n/D) in. Returns the global exclusive prefix of f
    and the global inclusive suffix of g as shard lists, and the products
    of all f and of all g, (16, 1) each on ``home``."""
    pre_f, suf_g, tot_f, tot_g = [], [], [], []
    for rows in zip(a, b, c, s1, s2, s3, roots):
        f, g = grand_product_fg(*rows, beta, gamma, k1, k2)
        p, tf = limbs.field_scan(FR, f, "mul", exclusive=True)
        s, tg = limbs.field_scan(FR, g, "mul", reverse=True)
        pre_f.append(p), suf_g.append(s), tot_f.append(tf), tot_g.append(tg)
    all_f, all_g = mesh.all_gather(tot_f), mesh.all_gather(tot_g)
    pre_f = [_fold_totals(p, t, d, reverse=False) for d, p, t in zip(mesh.ids, pre_f, all_f)]
    suf_g = [_fold_totals(s, t, d, reverse=True) for d, s, t in zip(mesh.ids, suf_g, all_g)]
    return pre_f, suf_g, _product(all_f[0]), _product(all_g[0])


def grand_product_part2(pre_f, suf_g, total_inv, mesh):
    """z on every shard: prefix of f times suffix of g times 1/(product of
    g); ``total_inv`` (16, 1) on ``home``."""
    inv = [total_inv.to(dev) for dev in mesh.devices]
    return [_mm(_mm(p, s), t) for p, s, t in zip(pre_f, suf_g, inv)]


def grand_product_shards(a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2, mesh):
    """(z shard list with z_0 = 1, closing z_n (16, 1) on ``home``), all
    Montgomery: the sharded ``TorchEngine._grand_product``."""
    pre_f, suf_g, total_f, total_g = grand_product_part1(
        a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2, mesh)
    total_inv = limbs.mont_pow_fixed(FR, total_g, Q - 2)
    return grand_product_part2(pre_f, suf_g, total_inv, mesh), _mm(total_f, total_inv)


def grand_product_sharded(a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2, mesh) -> list[int]:
    """list[int] boundary, n + 1 values z_0 .. z_n (the engine contract's
    ``grand_product``), n a multiple of the shard count."""
    rows = [mesh.shard(FR.pack_mont(v, mesh.home)) for v in (a, b, c, s1, s2, s3, roots)]
    z, closing = grand_product_shards(*rows, beta, gamma, k1, k2, mesh)
    return FR.unpack_mont(torch.cat([mesh.gather(z), closing], dim=-1))
