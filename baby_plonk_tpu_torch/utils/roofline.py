"""The least time an H100 could take for a kernel's work: the peaks and the
work counts that ``chip_smoke.py`` (each kernel's ``bound_ms``) and
``bench.py`` (``roofline_pct`` of the fixed-base MSM) share.

The card's peaks (NVIDIA H100 SXM data sheet, at its 700 W power limit):
HBM3 at 3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores = 33.5e12
fused multiply-adds a second on 128 lanes per SM, and the 32-bit integer
multiply-add pipe has half those lanes.
"""
from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
INT_MAD_PER_S = 67e12 / 2 / 2
#: 32-bit multiply-adds of one Montgomery product over N words
#: (csrc/field.cuh::mul): 2 N^2 + N; of one square (cross products once):
#: N (N + 1) / 2 + N^2 + N
FR_MUL, FQ_MUL = 2 * 8 * 8 + 8, 2 * 12 * 12 + 12
FR_SQR, FQ_SQR = 8 * 9 // 2 + 8 * 8 + 8, 12 * 13 // 2 + 12 * 12 + 12
#: Fq products of the point formulas (csrc/g1.cuh); 2 of the doubling's 8
#: are squares
ADD_MULS, DOUBLE_MULS, MIXED_MULS = 12, 8, 11
DOUBLE_MADS = 6 * FQ_MUL + 2 * FQ_SQR
#: bytes of one Fr / Fq element in memory (16-bit limbs in int32)
FR_BYTES, FQ_BYTES = 64, 96


def bound(nbytes, mads):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    32-bit multiply-adds over the integer rate."""
    t_b, t_o = nbytes / MEM_BYTES_PER_S * 1e3, mads / INT_MAD_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def horner_work(sc, G, windows, lane_groups=1, chunk_groups=None):
    """(bytes, multiply-adds) of one Horner launch of the fixed-base MSM
    (``msm_fixed.msm_fixed_horner``) over raw scalars ``sc`` (16, P, 8 G) at
    K = ``lane_groups`` groups a lane in chunks of ``chunk_groups`` (default
    G): tables of the G groups, scalars and partials once; per lane and
    step a doubling, and a mixed addition for each of its groups where this
    run's index is not 0."""
    from ..ops import msm_fixed

    P = sc.shape[1]
    gc = chunk_groups or G
    per_chunk, rest = msm_fixed.lane_slots(G, lane_groups, gc)
    slots = G // gc * per_chunk + rest
    nonzero = sum(int((msm_fixed._table_index(sc, bit) != 0).sum()) for bit in range(msm_fixed.NBITS))
    steps = P * msm_fixed._lanes_run(G, lane_groups, gc) * msm_fixed.window_bits(windows) * windows
    return (FQ_BYTES * 256 * G + FR_BYTES * P * 8 * G + 3 * FQ_BYTES * P * windows * slots,
            DOUBLE_MADS * steps + FQ_MUL * MIXED_MULS * nonzero)


def fermat_inverse_mads(modulus: int, sqr_mads: int, mul_mads: int) -> int:
    """Multiply-adds of a^(p - 2) by square-and-multiply: a square a bit,
    a product a set bit below the top."""
    e = modulus - 2
    return (e.bit_length() - 1) * sqr_mads + (bin(e).count("1") - 1) * mul_mads


#: complete additions that one group's 256 subset sums need: one for each
#: subset of two or more of the 8 points (the identity and the single
#: points are copies), however the build orders them
TABLE_ADDS = 256 - 1 - 8
#: Fq products of one group's normalization: Montgomery's trick, a prefix
#: product and two back-sweep products an entry, and 2 for (x, y). (The
#: kernel does 1568: csrc/msm_fixed.cu recomputes each lane's prefixes
#: rather than keep them, and adds a level of 32 segment products.)
TABLE_TRICK_MULS = (3 + 2) * 256


def tables_work(G):
    """(bytes, multiply-adds) of one table build over G groups
    (``msm_fixed.build_tables``): the 8 G projective points in and the
    packed entries out once; per group ``TABLE_ADDS`` complete additions,
    ``TABLE_TRICK_MULS`` products and one Fermat inversion."""
    from ..fields import fq

    inv = fermat_inverse_mads(fq.P, FQ_SQR, FQ_MUL)
    return (3 * FQ_BYTES * 8 * G + FQ_BYTES * 256 * G,
            G * (FQ_MUL * (ADD_MULS * TABLE_ADDS + TABLE_TRICK_MULS) + inv))


def powers_of_tau_work(sc):
    """(bytes, multiply-adds) of one launch of the windowed powers-of-tau
    kernel (``srs.powers_of_tau``) over raw scalars ``sc`` (16, n): the
    scalars in, the points out and the table of multiples read once; a
    mixed addition for each nonzero byte of this run's scalars."""
    from ..ops import srs

    nonzero = sum(int((srs._digit(sc, k) != 0).sum()) for k in range(srs.WINDOWS))
    return ((FR_BYTES + 3 * FQ_BYTES) * sc.shape[-1] + FQ_BYTES * 256 * srs.WINDOWS,
            FQ_MUL * MIXED_MULS * nonzero)


def tree_work(n, sets):
    """(bytes, multiply-adds) of one group tree (``g1_vec.tree_reduce``) over
    ``sets`` sets of n points: n points read and one written a set; n - 1
    complete additions a set. Its floor is its depth, log2(n) dependent
    additions, which no count of bytes or multiply-adds shows: chip_smoke
    states it beside this bound, from the time of one addition on one lane."""
    return 3 * FQ_BYTES * sets * (n + 1), FQ_MUL * ADD_MULS * sets * (n - 1)


def pippenger_work(ds, c):
    """(bytes, multiply-adds) of one variable-base Pippenger MSM
    (``msm_pippenger.msm_pippenger``) from this run's sorted digits ``ds``
    (nwin, n): the points read once a window, the scalars once, the sum
    written once; an addition for each point of a bucket after its first,
    two for each bucket up to a window's top digit (the running sums), and
    c doublings and an addition for each window below the top (Horner).
    The Horner chain is also its latency floor, which no count of bytes or
    multiply-adds shows: chip_smoke states it beside this bound, from the
    one-lane times of a doubling and an addition."""
    nwin, n = ds.shape
    nz = ds != 0
    buckets = int(nz[:, 0].sum()) + int(((ds[:, 1:] != ds[:, :-1]) & nz[:, 1:]).sum())
    adds = int(nz.sum()) - buckets + 2 * int(ds.max(dim=1).values.sum()) + (nwin - 1)
    return (3 * FQ_BYTES * n * nwin + FR_BYTES * n + 3 * FQ_BYTES,
            FQ_MUL * ADD_MULS * adds + DOUBLE_MADS * c * (nwin - 1))
