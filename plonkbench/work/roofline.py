"""The card's peaks and the work of one Horner launch of the fixed-base
commit, counted from the commit's shapes.

Frozen from ``baby_plonk_tpu_torch/utils/roofline.py`` (the peaks,
``bound``, ``horner_work``'s formula) and ``ops/msm_fixed.py`` (the launch's
groups and windows: ``launch_groups``, ``windows_for``, ``window_bits``) at
commit 7bdee1a. Only a change of the benchmark may change them.

Peaks (NVIDIA H100 SXM data sheet, at its 700 W power limit): HBM3 at
3.35 TB/s; 67 TFLOP/s float32 outside the tensor cores = 33.5e12 fused
multiply-adds a second on 128 lanes an SM, and the 32-bit integer
multiply-add pipe has half those lanes: 16.75e12 a second (an assumption
stated here, not a data-sheet figure).
"""
from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
INT_MAD_PER_S = 67e12 / 2 / 2
#: 32-bit multiply-adds of one Montgomery product over N words: 2 N^2 + N;
#: of one square: N (N + 1) / 2 + N^2 + N
FQ_MUL = 2 * 12 * 12 + 12
FQ_SQR = 12 * 13 // 2 + 12 * 12 + 12
#: Fq products of the point formulas: a mixed addition 11, a doubling 8 (2 squares)
MIXED_MULS = 11
DOUBLE_MADS = 6 * FQ_MUL + 2 * FQ_SQR
#: bytes of one Fr / Fq element in memory (16-bit limbs in int32)
FR_BYTES, FQ_BYTES = 64, 96

GROUP = 8
NBITS = 255
MAX_WINDOWS = 16
#: Horner lanes one SM keeps resident (3 blocks of 128 threads)
LANES_PER_SM = 384


def bound_s(nbytes: float, mads: float) -> float:
    """The least seconds: the larger of bytes over the memory rate and
    multiply-adds over the integer rate."""
    return max(nbytes / MEM_BYTES_PER_S, mads / INT_MAD_PER_S)


def _pow2_ceil(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def launch_groups(k: int, chunk: int) -> int:
    """Groups of 8 points the launch runs for scalars of length k: whole
    chunks, and the rest rounded up to a power of two."""
    gc = chunk // GROUP
    full, rest = divmod(max(-(-k // GROUP), 1), gc)
    return full * gc + (_pow2_ceil(rest) if rest else 0)


def windows_for(lanes: int, sms: int) -> int:
    """Windows: doubled while twice the lanes fit the card's resident lanes, at most 16."""
    w = 1
    while w < MAX_WINDOWS and lanes * w * 2 <= sms * LANES_PER_SM:
        w *= 2
    return w


def horner_work(P: int, k: int, chunk: int, sms: int) -> tuple[int, int]:
    """(bytes, multiply-adds) of the Horner launch of a commit of P scalar
    sets of length <= k: the tables of the G groups, the scalars and the
    partials once; per lane and step a doubling, and a mixed addition for
    each of the 255 bits of each lane. Every table index is counted
    nonzero: with the blinding every coefficient is a full-width field
    element, so an index of 8 bits is 0 with a chance of about 1/256 (and
    more often in the last, partly empty group): an overcount of the
    additions by about 0.4%."""
    G = launch_groups(k, chunk)
    W = windows_for(P * G, sms)
    S = -(-NBITS // W)
    steps = P * G * S * W
    return (FQ_BYTES * 256 * G + FR_BYTES * P * GROUP * G + 3 * FQ_BYTES * P * W * G,
            DOUBLE_MADS * steps + FQ_MUL * MIXED_MULS * P * G * NBITS)
