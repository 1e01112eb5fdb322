"""Pippenger (bucket-method) MSM on the device (counterpart of
``baby_plonk_tpu/ops/msm_pippenger.py``).

The reference's bucket loop (msm.rs:76-118) scatters points into buckets,
which a TPU cannot do; the JAX function turned it into data-parallel scans
(a Hillis–Steele segmented sum over all n sorted points, suffix sums over the
2^c buckets, one full-width point addition a level). On the card the bucket
work is one C entry point, ``bpt_msm_pippenger`` (csrc/pippenger.cu), a few
launches a call, whose design the source's header sets out:

  1. glue: the c-bit digits of every window as one (nwin, n) tensor, each
     row sorted stably (``torch.sort``, as the JAX function leaves its
     argsort to XLA outside any kernel);
  2. bucket sums: the sorted order of a window cut into chunks of K points,
     one thread a chunk adding each run of equal digits in order; a run that
     crosses a chunk's edge leaves a partial, and the partials are joined by
     further levels of the same walk over chunks of ``JOIN_K`` partials;
  3. window totals sum_d d B_d: the buckets cut into segments of L, one
     thread a segment's descending running sum, shifted by its first digit
     (double-and-add), then a halving tree over the segments;
  4. Horner from the top window: c doublings and an addition a window, one
     thread (the latency floor of a variable-base MSM).

Digit 0 adds nothing and is skipped. Every sum that may be empty carries a
presence flag instead of the identity, so no addition of the identity is
made. ``msm_pippenger_plain`` is the same walk, running sums, trees and
Horner on int64 lanes in the kernel's order of additions, so the kernel
equals it limb for limb; the JAX function adds in another order, so the two
packages agree as points (affine values). n is not padded to a power of two.
"""
from __future__ import annotations

import torch

from ..utils.metrics import get_metrics
from . import g1_vec, kernels

BITS = 255
#: partials a thread walks at the join levels (every level after the first):
#: each level leaves at most two partials a chunk, so it halves at least
#: every other level and a bucket that holds every point is joined in a
#: depth of log(n / K) levels of at most JOIN_K - 1 additions
JOIN_K = 8
#: threads of a block of the walk and segment kernels (csrc/pippenger.cu)
THREADS = 128
#: threads an SM holds at once: a thread takes about 248 registers
#: (two points and the formula's temporaries), two blocks of 128 an SM
RESIDENT_PER_SM = 256


def window_c(n: int) -> int:
    if n < 1 << 10:
        return 8
    if n < 1 << 16:
        return 12
    return 14


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


def windows(c: int) -> int:
    return (BITS + c - 1) // c


def window_digits(scalars, c: int):
    """(nwin, n) int64: the digits of every window, row w = ``_window_digits(
    scalars, w, c)``."""
    nwin = windows(c)
    sc = torch.cat([scalars.to(torch.int64), scalars.new_zeros((1, scalars.shape[-1]), dtype=torch.int64)])
    lo_bit = torch.arange(nwin, device=scalars.device) * c
    li0 = lo_bit >> 4
    word = sc[li0] | (sc[li0 + 1] << 16)
    return (word >> (lo_bit & 15)[:, None]) & ((1 << c) - 1)


def sorted_digits(scalars, c: int):
    """(ds, order): each window's digits sorted stably and the points' indices
    in that order, both (nwin, n) int64."""
    return torch.sort(window_digits(scalars, c), dim=1, stable=True)


def make_plan(n: int, c: int, sms: int = 132) -> tuple[int, int, int, int]:
    """(K, JOIN_K, L, BS) of one call over n points on a card of ``sms`` SMs:
    chunks of K points, as short as fills the card's resident threads once
    (at least 4, so each join level shrinks); segments of L buckets, the
    shortest power of two whose threads fit the card at once; BS segments a
    block of the segment kernel."""
    nwin, nb = windows(c), 1 << c
    resident = sms * RESIDENT_PER_SM
    k = max(4, -(-nwin * n // resident))
    seg = 1
    while seg < nb and (nwin * nb // seg > resident or nb // seg > THREADS * THREADS):
        seg *= 2
    return k, JOIN_K, seg, min(nb // seg, THREADS)


def levels(n: int, k0: int, k1: int) -> list[tuple[int, int]]:
    """(elements a window, chunk length) of each walk level: the first over
    the n sorted points, each later one over the two partial slots a chunk of
    the level before leaves; the last level is one chunk a window."""
    out, m, k = [], n, k0
    while True:
        out.append((m, k))
        if m <= k:
            return out
        m, k = 2 * -(-m // k), k1


def _check_plan(c: int, p) -> None:
    """Raise unless plan ``p`` is one the kernels take at width c (csrc/
    pippenger.cu::layout states the same rules)."""
    k0, k1, seg, bs = p
    nb = 1 << c
    nseg = nb // max(seg, 1)
    if not 1 <= c <= 16:
        raise ValueError(f"msm_pippenger: window width {c} outside 1..16")
    if k0 < 4 or k1 < 4:
        raise ValueError(f"msm_pippenger: chunks of {k0} and {k1} (at least 4)")
    if seg < 1 or seg & (seg - 1) or seg > nb or bs < 1 or bs & (bs - 1) or bs > THREADS or nseg % bs \
            or nseg // bs > THREADS:
        raise ValueError(f"msm_pippenger: segments of {seg}, blocks of {bs} at c = {c}")


# -- the plain version (int64 lanes, the kernel's order of additions) -----------


def _pick(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _on_lanes(fn, mask, base, *args):
    """``base`` with fn(*args) on the lanes of ``mask`` (point batches of one
    shape): the formula runs on those lanes only."""
    if not bool(mask.any()):
        return base
    idx = mask.reshape(-1).nonzero().squeeze(1)
    flat = [tuple(q.reshape(24, -1)[:, idx] for q in a) for a in args]
    out = tuple(q.reshape(24, -1).clone() for q in base)
    for o, v in zip(out, fn(*flat)):
        o[:, idx] = v
    return tuple(o.reshape(q.shape) for o, q in zip(out, base))


def _comb(a, ha, b, hb):
    """Presence-aware sum: a + b where both are present, else the present
    one (a copy, no addition of the identity); flags ha | hb."""
    return _on_lanes(g1_vec.padd_plain, ha & hb, _pick(ha, a, b), a, b), ha | hb


def _walk_plain(keys, k, load, bucket, present):
    """One walk level over keys (nwin, m) = label << 1 | valid. Runs that
    close inside a chunk go into ``bucket`` / ``present`` (in place); returns
    the next level's (keys, points), each chunk's two slots (its first run if
    that crosses the left edge, its last run if that crosses the right), or
    None at a level of one chunk."""
    nwin, m = keys.shape
    dev = keys.device
    chunks = -(-m // k)
    lo = torch.arange(chunks, device=dev) * k
    hi = (lo + k).clamp(max=m)
    lab = keys >> 1
    w_idx = torch.arange(nwin, device=dev)[:, None].expand(nwin, chunks)
    shape = (nwin, chunks)
    cur = lab[:, lo]
    cl0 = (lo > 0) & (lab[:, (lo - 1).clamp(min=0)] == cur)
    nxt = torch.where(hi < m, lab[:, hi.clamp(max=m - 1)], torch.full_like(cur, -1))
    first = torch.ones(shape, dtype=torch.bool, device=dev)
    have = torch.zeros(shape, dtype=torch.bool, device=dev)
    acc = g1_vec.pidentity(shape, dev, torch.int64)
    slot = [g1_vec.pidentity(shape, dev, torch.int64) for _ in range(2)]
    key = [torch.zeros(shape, dtype=torch.int64, device=dev) for _ in range(2)]
    for t in range(k + 1):
        p = lo + t
        end, step = (p == hi).expand(shape), (p < hi).expand(shape)
        pc = p.clamp(max=m - 1).expand(shape)
        kp = keys[w_idx, pc]
        close = end | (step & (t > 0) & ((kp >> 1) != cur))
        cl, cr = first & cl0, end & (nxt == cur)
        fin = close & ~cl & ~cr & have
        if bool(fin.any()):
            wi, ci = w_idx[fin], cur[fin]
            for b, a in zip(bucket, acc):
                b[:, wi, ci] = a[:, fin]
            present[wi, ci] = True
        out0, out1 = close & cl, close & ~cl & cr
        run_key = (cur << 1) | have.long()
        slot[0], key[0] = _pick(out0, acc, slot[0]), torch.where(out0, run_key, key[0])
        slot[1], key[1] = _pick(out1, acc, slot[1]), torch.where(out1, run_key, key[1])
        key[1] = torch.where(out0 & cr, cur << 1, key[1])
        new = close & ~end
        cur = torch.where(new, kp >> 1, cur)
        first, have = first & ~new, have & ~new
        take = step & ((kp & 1) == 1)
        if bool(take.any()):
            acc, have = _comb(acc, have, load(w_idx, pc), take)
    if chunks == 1:
        return None
    keys_out = torch.stack(key, -1).reshape(nwin, 2 * chunks)
    pts_out = tuple(torch.stack([a, b], -1).reshape(24, nwin, 2 * chunks) for a, b in zip(*slot))
    return keys_out, pts_out


def bucket_sums_plain(points, ds, order, k0: int, k1: int, c: int):
    """Plain bucket sums of every window: ((24, nwin, 2^c) x3 int64, present
    (nwin, 2^c) bool) from the sorted digits ``ds`` and indices ``order``
    (nwin, n); bucket 0 is never present."""
    nwin, n = ds.shape
    dev = ds.device
    bucket = g1_vec.pidentity((nwin, 1 << c), dev, torch.int64)
    present = torch.zeros((nwin, 1 << c), dtype=torch.bool, device=dev)
    pts = g1_vec._to64(points)
    nxt = _walk_plain((ds << 1) | (ds != 0).long(), k0,
                      lambda wi, pc: tuple(q[:, order[wi, pc]] for q in pts), bucket, present)
    while nxt is not None:
        keys, lvl = nxt
        nxt = _walk_plain(keys, k1, lambda wi, pc, lvl=lvl: tuple(q[:, wi, pc] for q in lvl), bucket, present)
    return bucket, present


def _halve_plain(pts, flag):
    """Halving tree with presence over the last axis (a power of two): level
    h sums lane i + h into lane i, i < h."""
    axis_len = flag.shape[-1]
    while axis_len > 1:
        h = axis_len // 2
        pts, flag = _comb(tuple(q[..., :h] for q in pts), flag[..., :h],
                          tuple(q[..., h:axis_len] for q in pts), flag[..., h:axis_len])
        axis_len = h
    return tuple(q[..., 0] for q in pts), flag[..., 0]


def window_totals_plain(bucket, present, c: int, seg: int, bs: int):
    """sum_{d >= 1} d B_d of every window: ((24, nwin) x3 int64, present
    (nwin,) bool). Segment s of ``seg`` buckets from lo = s seg: the running
    sum R from the top bucket down, T += R at every bucket above lo, then
    T + lo R (lo R by double-and-add from the top bit); then a halving tree
    over each block's ``bs`` segments and one over each window's blocks."""
    nwin, nb = present.shape
    dev = present.device
    nseg = nb // seg
    B = tuple(q.reshape(24, nwin, nseg, seg) for q in bucket)
    P = present.reshape(nwin, nseg, seg)
    shape = (nwin, nseg)
    none = torch.zeros(shape, dtype=torch.bool, device=dev)
    R, hr = g1_vec.pidentity(shape, dev, torch.int64), none
    T, ht = g1_vec.pidentity(shape, dev, torch.int64), none
    for r in range(seg - 1, -1, -1):
        R, hr = _comb(R, hr, tuple(q[..., r] for q in B), P[..., r])
        if r > 0:
            T, ht = _comb(T, ht, R, hr)
    lo = torch.arange(nseg, device=dev) * seg
    S, hs = g1_vec.pidentity(shape, dev, torch.int64), none
    for bit in range(c - 1, -1, -1):
        S = _on_lanes(g1_vec.pdouble_plain, hs, S, S)
        S, hs = _comb(S, hs, R, hr & (((lo >> bit) & 1) == 1))
    T, ht = _comb(T, ht, S, hs)
    blocks = nseg // bs
    part = _halve_plain(tuple(q.reshape(24, nwin, blocks, bs) for q in T), ht.reshape(nwin, blocks, bs))
    return _halve_plain(*part)


def horner_plain(wtot, wflag, c: int):
    """sum_w 2^(c w) W_w from the top window: c doublings (once the total is
    present) and the window's total (where present) a window."""
    dev = wflag.device
    tot, have = g1_vec.pidentity((), dev, torch.int64), False
    for w in range(wflag.shape[0] - 1, -1, -1):
        if have:
            for _ in range(c):
                tot = g1_vec.pdouble_plain(tot)
        if bool(wflag[w]):
            q = tuple(x[:, w] for x in wtot)
            tot = g1_vec.padd_plain(tot, q) if have else q
            have = True
    return tot


def msm_pippenger_plain(points, scalars, c: int | None = None, plan=None):
    """Plain version of ``msm_pippenger``: int64 (24,) x3, the kernel's
    additions in the kernel's order under the same plan."""
    n = points[0].shape[-1]
    c = window_c(n) if c is None else c
    p = make_plan(n, c) if plan is None else plan
    _check_plan(c, p)
    ds, order = sorted_digits(scalars, c)
    bucket, present = bucket_sums_plain(points, ds, order, p[0], p[1], c)
    wtot, wflag = window_totals_plain(bucket, present, c, p[2], p[3])
    return horner_plain(wtot, wflag, c)


def msm_pippenger(points, scalars, c: int | None = None, plan=None):
    """Full MSM of (24, n) x3 Montgomery points by (16, n) raw scalars;
    returns (X, Y, Z) limb vectors (24,). ``plan`` = (K, JOIN_K, L, BS)
    (default ``make_plan`` for the card). On a CUDA tensor: the sort (glue) and
    ONE call of ``bpt_msm_pippenger``; ``launches`` counts those calls. Every
    call, on any device, counts ``pippenger_msms`` and ``pippenger_points``
    and runs inside the span ``msm.pippenger`` of size n (utils/metrics.py)."""
    n = points[0].shape[-1]
    m = get_metrics()
    m.count("pippenger_msms")
    m.count("pippenger_points", n)
    with m.span("msm.pippenger", size=n):
        return _msm_pippenger(points, scalars, n, window_c(n) if c is None else c, plan)


def _msm_pippenger(points, scalars, n: int, c: int, plan):
    if kernels.on_cpu(*points, scalars):
        return g1_vec._to32(msm_pippenger_plain(points, scalars, c, plan))
    dev = kernels.check_cuda(*points, scalars)
    if scalars.shape != (16, n) or any(q.shape != (24, n) for q in points):
        raise ValueError("msm_pippenger: points must be (24, n) x3 and scalars (16, n)")
    p = make_plan(n, c, torch.cuda.get_device_properties(dev).multi_processor_count) if plan is None else plan
    _check_plan(c, p)
    ds, order = sorted_digits(scalars, c)
    ds, order = ds.to(torch.int32), order.to(torch.int32)
    points = tuple(q.contiguous() for q in points)
    lib = kernels.library()
    words = lib.bpt_msm_pippenger_scratch(n, c, *p)
    if words < 0:
        raise ValueError(f"msm_pippenger: plan {p} refused at n = {n}, c = {c}")
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    out = tuple(torch.empty(24, dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("bpt_msm_pippenger", dev, *(kernels.ptr(q) for q in points), n, kernels.ptr(ds),
                   kernels.ptr(order), c, *p, kernels.ptr(scratch), words, *(kernels.ptr(q) for q in out))
    msm_pippenger.launches += 1
    return out


msm_pippenger.launches = 0
