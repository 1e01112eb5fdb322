"""Distributed NTT: the four-step split over the mesh (counterpart of
``baby_plonk_tpu/parallel/dntt.py``).

A size-n transform, n = D m over D shards, is
  (1) a D-point NTT across the former shard axis (made local by an
      ``all_to_all``),
  (2) a twiddle by w^(i2 k1),
  (3) a second ``all_to_all``, and
  (4) a local m-point NTT,
with w the order-n root. Index algebra (i = i1 m + i2, k = k2 D + k1):

  X[k2 D + k1] = NTT_m over i2 [ w^(i2 k1) NTT_D over i1 [ x[i1 m + i2] ] ]

so a block-sharded natural-order input gives an output where shard k1
holds the strided slice {k : k = k1 (mod D)} ("cyclic" order: gathered
position k1 m + k2 holds X[k2 D + k1]). The dual runs the chain backwards:
it takes the cyclic layout and returns the inverse transform in natural
block order, so a forward transform, a pointwise step and the dual need no
global permute.

Every transform is the port's NTT on a shard: the D-point one along axis
-2 (``kernels.ntt_sub_4step``, the batch lanes inner), the m-point one
along the last axis (``ntt.ntt_device``). Both scale an inverse, by 1/D and
1/m, which compose to the 1/n of the whole inverse transform.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import fr
from ..ops import kernels, limbs, ntt
from ..ops.limbs import FR

Q = fr.Q


def cyclic_perm(n: int, D: int) -> np.ndarray:
    """Entry p is the natural index at gathered position p of the cyclic
    layout: position k1 m + k2 holds k2 D + k1."""
    m = n // D
    return (np.arange(m)[None, :] * D + np.arange(D)[:, None]).reshape(-1)


def check_shape(n: int, D: int) -> None:
    if n % D or (n // D) % D:
        raise ValueError(f"distributed NTT: need n = D m with D | m (n = {n}, D = {D})")


@functools.lru_cache(maxsize=None)
def _twiddle_block(n: int, D: int, d: int, inverse: bool, device: str) -> torch.Tensor:
    """(16, D, m/D) Montgomery on ``device``: w^(i2 k1) for k1 < D and
    i2 = d m/D + c, c < m/D, w the order-n root (its inverse). Row k1 is a
    geometric sequence: one power table of w^k1, times w^(d m/D k1)."""
    mD = n // D // D
    w = ntt._root(n, inverse)
    rows = [
        limbs.mont_mul(FR, limbs.pow_table(FR, FR.mont_scalar(pow(w, k1, Q), device), mD),
                       FR.mont_scalar(pow(w, d * mD * k1, Q), device))
        for k1 in range(D)
    ]
    return torch.stack(rows, dim=1).contiguous()


def _twiddle(x: torch.Tensor, n: int, D: int, d: int, inverse: bool) -> torch.Tensor:
    """x (16, K, D, m/D) on shard d times its twiddle block."""
    return limbs.mont_mul(FR, x, _twiddle_block(n, D, d, inverse, str(x.device))[:, None])


def _local_fourstep(shards, mesh, inverse: bool):
    """Forward chain over the mesh. ``shards``: (16, K, m) each, shard d
    holding rows i1 = d (x[d m + i2]); returns (16, K, m) each, shard d
    holding X[k2 D + d]."""
    D = mesh.D
    _, K, m = shards[0].shape
    mD = m // D
    n = D * m
    # transpose 1: shard d gets chunk d of every row i1 -> (K, D, m/D)
    a = mesh.all_to_all(shards, -1, -1)
    out = []
    for d, x in zip(mesh.ids, a):
        # step 1: D-point NTT over i1 (axis -2); step 2: twiddle w^(i2 k1)
        x = kernels.ntt_sub_4step(x.reshape(16, K, D, mD), inverse, scaled=True)
        out.append(_twiddle(x, n, D, d, inverse))
    # transpose 2: row k1 = d of every shard to shard d -> i2 natural
    a = mesh.all_to_all(out, -2, -2)
    # step 4: local m-point NTT over i2
    return [ntt.ntt_device(x.reshape(16, K, m), inverse) for x in a]


def _local_fourstep_dual(shards, mesh):
    """The forward chain run backwards: takes the cyclic layout of
    ``_local_fourstep`` (shard d holds X[k2 D + d], (16, K, m) each) and
    returns the inverse transform in natural block order."""
    D = mesh.D
    _, K, m = shards[0].shape
    mD = m // D
    n = D * m
    # undo step 4: local m-point inverse NTT over k2 -> i2 natural
    a = [ntt.ntt_device(x, inverse=True).reshape(16, K, D, mD) for x in shards]
    # undo transpose 2: i2 chunk j to shard j -> shard d holds [k1, c], i2 = d m/D + c
    a = mesh.all_to_all(a, -2, -2)
    out = []
    for d, x in zip(mesh.ids, a):
        # undo the twiddle, then the D-point inverse NTT over k1 -> i1
        x = kernels.ntt_sub_4step(_twiddle(x, n, D, d, True), True, scaled=True)
        out.append(x.reshape(16, K, m))
    # undo transpose 1: chunk i1 back to shard i1
    return mesh.all_to_all(out, -1, -1)


def ntt_sharded(a_mont: torch.Tensor, mesh, inverse: bool = False) -> torch.Tensor:
    """Distributed NTT of (16, ..., n) Montgomery limbs: block-sharded over
    the mesh, gathered on ``home`` in cyclic order (position k1 m + k2 holds
    X[k2 D + k1])."""
    n = a_mont.shape[-1]
    check_shape(n, mesh.D)
    flat = a_mont.reshape(16, -1, n)
    out = _local_fourstep(mesh.shard(flat), mesh, inverse)
    return mesh.gather(out).reshape(a_mont.shape)


def ntt_ints_sharded(values: list[int], mesh, inverse: bool = False) -> list[int]:
    """list[int] in and out, natural order (the cyclic layout reordered)."""
    n = len(values)
    out = ntt_sharded(FR.pack_mont(values, mesh.home), mesh, inverse)
    vals = FR.unpack_mont(out)
    res = [0] * n
    for p, k in enumerate(cyclic_perm(n, mesh.D).tolist()):
        res[k] = vals[p]
    return res
