"""Pippenger (bucket-method) MSM on the device — sort + segmented reduction
(counterpart of ``baby_plonk_tpu/ops/msm_pippenger.py``).

The reference's bucket loop (msm.rs:76-118) is a data-dependent scatter;
the data-parallel formulation per window is:

  1. digit extraction  d_i = (s_i >> w*c) & (2^c - 1)          (elementwise)
  2. stable argsort by digit; gather points into digit order
  3. segmented inclusive "sum" over equal-digit runs via a
     Hillis–Steele scan of complete point adds (log2(n) full-width passes)
     — the last lane of each run then holds that bucket's sum
  4. bucket table: run-end lanes located with searchsorted, gathered into
     a dense (2^c) array (identity-padded)
  5. sum_d d * B_d via suffix sums over the dense bucket axis
     (the reference's descending accumulation, msm.rs:42-47, as a scan)

Windows combine Horner-style with c doublings (msm.rs:107-115).

A composition: the point passes launch this package's kernels
(``g1_vec.padd``, ``g1_vec.pdouble``, ``g1_vec.tree_reduce``); digit
extraction, ``argsort``, ``index_select``, ``searchsorted`` and ``where``
are tensor glue, as the JAX version leaves them to XLA outside any Pallas
kernel. The scan's result does not depend on the order inside a run only as
a point, not limb for limb, so this agrees with the JAX function at affine
values. n is not padded to a power of two; the bucket count 2^c is.
"""
from __future__ import annotations

import torch

from . import g1_vec

BITS = 255


def window_c(n: int) -> int:
    if n < 1 << 10:
        return 8
    if n < 1 << 16:
        return 12
    return 14


def _take(p, idx):
    return tuple(c.index_select(-1, idx) for c in p)


def _segmented_sum(p, seg):
    """Inclusive segmented point-sum along the batch axis (seg sorted)."""
    n = seg.shape[0]
    logn = max(n - 1, 1).bit_length()
    idx = torch.arange(n, device=seg.device)
    for s in range(logn):
        shift = 1 << s
        partner = (idx - shift).clamp_(min=0)
        same = (seg.index_select(0, partner) == seg) & (idx >= shift)
        p = g1_vec.pselect(same, g1_vec.padd(p, _take(p, partner)), p)
    return p


def _bucket_suffix_total(bucket, c: int):
    """sum_{d>=1} d * B_d via suffix sums then a tree reduce; bucket is a
    dense (24, 2^c) x3 table."""
    nb = 1 << c
    idx_b = torch.arange(nb, device=bucket[0].device)
    suf = bucket
    for s in range(c):
        shift = 1 << s
        partner = (idx_b + shift).clamp_(max=nb - 1)
        valid = idx_b + shift <= nb - 1
        suf = g1_vec.pselect(valid, g1_vec.padd(suf, _take(suf, partner)), suf)
    # S_0 includes every bucket (digit 0 contributes nothing): drop it
    suf = g1_vec.pselect(idx_b >= 1, suf, g1_vec.pidentity((nb,), idx_b.device))
    return g1_vec.tree_reduce(suf)


def _window_digits(scalars, w: int, c: int):
    """(n,) int64 digits of window ``w``: bits [w*c, w*c + c) of the raw
    (16, n) scalars. The digit may straddle two 16-bit limbs; the limb past
    the top one is zero."""
    lo_bit = w * c
    li0 = lo_bit >> 4
    word = scalars[li0].to(torch.int64)
    if li0 + 1 <= 15:
        word = word | (scalars[li0 + 1].to(torch.int64) << 16)
    return (word >> (lo_bit & 15)) & ((1 << c) - 1)


def msm_pippenger(points, scalars, c: int | None = None):
    """Full MSM of (24, n) x3 Montgomery points by (16, n) raw scalars;
    returns (X, Y, Z) limb vectors (24,)."""
    n = points[0].shape[-1]
    if c is None:
        c = window_c(n)
    if not 1 <= c <= 16:
        raise ValueError(f"msm_pippenger: window width {c} outside 1..16")
    dev = scalars.device
    nwin = (BITS + c - 1) // c
    nb = 1 << c
    idx_b = torch.arange(nb, device=dev)
    ident_b = g1_vec.pidentity((nb,), dev)
    total = g1_vec.pidentity((), dev)
    for w in range(nwin - 1, -1, -1):  # MSB window first
        d = _window_digits(scalars, w, c)
        order = torch.argsort(d, stable=True)
        ds = d.index_select(0, order)
        ps = _segmented_sum(_take(points, order), ds)

        pos = torch.searchsorted(ds, idx_b, right=True) - 1
        pos_c = pos.clamp(0, n - 1)
        found = (pos >= 0) & (ds.index_select(0, pos_c) == idx_b)
        bucket = g1_vec.pselect(found, _take(ps, pos_c), ident_b)
        wtotal = _bucket_suffix_total(bucket, c)

        # Horner: shift the running total by c bits, then add this window
        # (doubling the initial identity is a no-op, so unconditional)
        for _ in range(c):
            total = g1_vec.pdouble(total)
        total = g1_vec.padd(total, wtotal)
    return total
