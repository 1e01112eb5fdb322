"""The work of one variable-base Pippenger MSM over n points, counted from n
alone, and the kernels whose traced time it is held against.

Frozen from ``baby_plonk_tpu_torch/utils/roofline.py::pippenger_work`` (the
formula) and ``ops/msm_pippenger.py`` (``window_c``, ``windows``) at commit
c3fa06d; the peaks and ``bound_s`` are ``plonkbench/work/roofline.py``'s.
Only a change of the benchmark may change them.

The method (the port's formula): the points read once a window, the scalars
once, the sum written once; a complete addition for each point of a bucket
after its first, two for each bucket up to a window's top digit (the
running sums), and c doublings and an addition for each window below the top
(Horner). The port counts buckets and top digits from a run's sorted digits.
Here the digits are taken saturated: every digit nonzero, in each window
every bucket present (as many as there are points, where fewer) and the top
digit at its window's largest value (the top window has 255 - (nwin - 1) c
bits: 3 at c = 14). With full-width random scalars over 2^16 points this
lies above the real digits' count by about 0.23%: the top window's digit is
0 for about one scalar in eight, which outweighs the buckets left empty (about
e^-4 of them in each full window). So the work is the same whatever
implements the MSM, and a later change of c or of the kernels is judged by
its time.
"""
from __future__ import annotations

from plonkbench.work.roofline import DOUBLE_MADS, FQ_BYTES, FQ_MUL, FR_BYTES, bound_s

BITS = 255
#: Fq products of a complete projective addition (csrc/g1.cuh)
ADD_MULS = 12
#: the kernels of one ``bpt_msm_pippenger`` call (csrc/pippenger.cu), by
#: ``plonkbench.tracing.short_name``
KERNELS = ("repack_kernel", "walk_kernel", "segment_kernel", "window_kernel", "horner_kernel")


def window_c(n: int) -> int:
    if n < 1 << 10:
        return 8
    if n < 1 << 16:
        return 12
    return 14


def windows(c: int) -> int:
    return (BITS + c - 1) // c


def top_digits(n: int) -> list[int]:
    """The largest digit of each window at the frozen width for n points."""
    c = window_c(n)
    return [(1 << min(c, BITS - w * c)) - 1 for w in range(windows(c))]


def pippenger_work(n: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of one call over n points, the digits saturated."""
    c, tops = window_c(n), top_digits(n)
    nwin = len(tops)
    buckets = sum(min(n, d) for d in tops)
    adds = nwin * n - buckets + 2 * sum(tops) + (nwin - 1)
    return (3 * FQ_BYTES * n * nwin + FR_BYTES * n + 3 * FQ_BYTES,
            FQ_MUL * ADD_MULS * adds + DOUBLE_MADS * c * (nwin - 1))


def pippenger_bound_s(n: int) -> float:
    """The least seconds an H100 could take for one call over n points."""
    return bound_s(*pippenger_work(n))
