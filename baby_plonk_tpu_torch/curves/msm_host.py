"""Host-side multi-scalar multiplication (Pippenger) over G1.

Correctness oracle and exact counterpart of the device MSM
(baby_plonk_tpu_torch.ops.msm). Functional equivalent of src/msm.rs:76-118 but
with a size-adaptive window (the reference hardcodes c = 4, setup.rs:36)
and LSB-first windows (mathematically identical result).
"""
from __future__ import annotations

from ..fields.fr import Q
from .g1 import G1


def _window_size(n: int) -> int:
    if n < 4:
        return 1
    if n < 32:
        return 3
    if n < 256:
        return 5
    if n < 4096:
        return 8
    if n < 65536:
        return 11
    return 13


def msm(points: list[G1], scalars: list[int], c: int | None = None) -> G1:
    """sum_i scalars[i] * points[i]."""
    n = min(len(points), len(scalars))
    if n == 0:
        return G1.identity()
    if n == 1:
        return points[0] * scalars[0]
    if c is None:
        c = _window_size(n)
    scalars = [s % Q for s in scalars[:n]]
    points = points[:n]
    num_windows = (255 + c - 1) // c
    mask = (1 << c) - 1

    window_sums: list[G1] = []
    for w in range(num_windows):
        shift = w * c
        buckets: dict[int, G1] = {}
        for p, s in zip(points, scalars):
            digit = (s >> shift) & mask
            if digit:
                cur = buckets.get(digit)
                buckets[digit] = p if cur is None else cur + p
        # descending running-sum accumulation (cf. msm.rs:42-47)
        acc = G1.identity()
        total = G1.identity()
        for d in range(max(buckets) if buckets else 0, 0, -1):
            b = buckets.get(d)
            if b is not None:
                acc = acc + b
            total = total + acc
        window_sums.append(total)

    # Horner combine, MSB window first
    result = window_sums[-1]
    for w in range(num_windows - 2, -1, -1):
        for _ in range(c):
            result = result.double()
        result = result + window_sums[w]
    return result


def _wnaf(k: int, w: int) -> list[int]:
    """Width-w non-adjacent form digits of k >= 0, LSB first (odd digits
    in (-2^(w-1), 2^(w-1)))."""
    digits = []
    half = 1 << (w - 1)
    full = 1 << w
    while k:
        if k & 1:
            d = k & (full - 1)
            if d >= half:
                d -= full
            k -= d
        else:
            d = 0
        digits.append(d)
        k >>= 1
    return digits


def multiexp(points: list[G1], scalars: list[int]) -> G1:
    """Straus interleaved-wNAF multi-exponentiation: sum_i scalars[i]*points[i]
    with ONE shared ~255-step doubling chain across all terms (vs one chain
    per term in verifier.rs:136-179's serial scalar muls). For the ~18-term
    combination of the PLONK final check this is ~4x fewer point ops than
    independent wNAF muls; for large n use ``msm`` (Pippenger) instead."""
    w = 4
    tables: list[list[G1]] = []
    naf: list[list[int]] = []
    maxlen = 0
    for p, k in zip(points, scalars):
        k = int(k) % Q
        if k == 0 or p.is_identity():
            continue
        dbl = p.double()
        tab = [p]
        for _ in range((1 << (w - 2)) - 1):
            tab.append(tab[-1] + dbl)
        digits = _wnaf(k, w)
        tables.append(tab)
        naf.append(digits)
        maxlen = max(maxlen, len(digits))
    acc = G1.identity()
    for j in range(maxlen - 1, -1, -1):
        acc = acc.double()
        for tab, digits in zip(tables, naf):
            if j < len(digits):
                d = digits[j]
                if d > 0:
                    acc = acc + tab[d >> 1]
                elif d < 0:
                    acc = acc - tab[(-d) >> 1]
    return acc


def msm_naive(points: list[G1], scalars: list[int]) -> G1:
    """Oracle: plain sum of scalar multiplications."""
    acc = G1.identity()
    for p, s in zip(points, scalars):
        acc = acc + p * s
    return acc
