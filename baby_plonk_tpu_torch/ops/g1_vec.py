"""BLS12-381 G1 point batches for the port: plain point formulas, the
elementwise addition launcher, host <-> device codecs, normalization and
tree reduction.

A batch is a tuple (X, Y, Z) of (24, *batch) int32 Montgomery limb tensors
in homogeneous projective coordinates (x = X/Z, y = Y/Z), identity
(0 : 1 : 0) — the layout of ``baby_plonk_tpu/ops/g1_vec.py``. The formulas
are Renes–Costello–Batina 2015 Algorithms 7/9/8 for a = 0, b3 = 12, as
there (padd :132, pdouble :165, padd_mixed :188); the plain versions here
compute the same canonical coordinates as the JAX package and as the
device functions of ``csrc/g1.cuh``.

Kernels (csrc/g1.cu): ``bpt_g1_tree``, every set of a batch summed in one
launch (``tree_reduce``); ``bpt_g1_padd``, the elementwise addition (the
JAX ``g1_vec.padd``; no prove runs it since the Pippenger MSM has kernels of
its own, csrc/pippenger.cu); ``bpt_g1_pdouble``, the SRS's doubling chain.
"""
from __future__ import annotations

import torch

from ..fields import fq

from . import kernels, limbs

FQ = limbs.FQ


# -- plain field helpers on int64 limbs (several independent operations are
#    stacked into one call to keep the op count down) --------------------------


def _mm(*pairs):
    a = torch.stack([x for x, _ in pairs], 1)
    b = torch.stack([y for _, y in pairs], 1)
    return limbs._mont_mul_plain(FQ, a, b).unbind(1)


def _add(*pairs):
    a = torch.stack([x for x, _ in pairs], 1)
    b = torch.stack([y for _, y in pairs], 1)
    return limbs._add_plain(FQ, a, b).unbind(1)


def _sub(*pairs):
    a = torch.stack([x for x, _ in pairs], 1)
    b = torch.stack([y for _, y in pairs], 1)
    return limbs._sub_plain(FQ, a, b).unbind(1)


def _mul12(*xs):
    a = torch.stack(xs, 1)
    a2 = limbs._add_plain(FQ, a, a)
    a4 = limbs._add_plain(FQ, a2, a2)
    a8 = limbs._add_plain(FQ, a4, a4)
    return limbs._add_plain(FQ, a8, a4).unbind(1)


def _to64(p):
    return tuple(c.to(torch.int64) for c in p)


def _to32(p):
    return tuple(c.to(torch.int32) for c in p)


def padd_plain(p, q):
    """Complete projective addition (RCB15 Algorithm 7, a = 0), int64."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    s0, s1, s2, s3, s4, s5 = _add((X1, Y1), (Y1, Z1), (X1, Z1), (X2, Y2), (Y2, Z2), (X2, Z2))
    t0, t1, t2, m3, m4, m5 = _mm((X1, X2), (Y1, Y2), (Z1, Z2), (s0, s3), (s1, s4), (s2, s5))
    a01, a12, a02, t0_2 = _add((t0, t1), (t1, t2), (t0, t2), (t0, t0))
    t3, t4, t5 = _sub((m3, a01), (m4, a12), (m5, a02))
    (t0_3,) = _add((t0_2, t0))
    bz, y3t = _mul12(t2, t5)
    (z3t,) = _add((t1, bz))
    (t1m,) = _sub((t1, bz))
    w0, w1, w2, w3, w4, w5 = _mm(
        (t3, t1m), (t4, y3t), (y3t, t0_3), (t1m, z3t), (z3t, t4), (t0_3, t3)
    )
    (X3,) = _sub((w0, w1))
    Y3, Z3 = _add((w2, w3), (w4, w5))
    return X3, Y3, Z3


def pdouble_plain(p):
    """Complete projective doubling (RCB15 Algorithm 9, a = 0), int64."""
    X, Y, Z = p
    t0, zz, t1, xy = _mm((Y, Y), (Z, Z), (Y, Z), (X, Y))
    (z3,) = _add((t0, t0))
    (z3,) = _add((z3, z3))
    (z3,) = _add((z3, z3))
    (t2,) = _mul12(zz)
    y3p, t2_2 = _add((t0, t2), (t2, t2))
    (t2_3,) = _add((t2_2, t2))
    (t0m,) = _sub((t0, t2_3))
    w0, w1, Z3, x3b = _mm((t2, z3), (t0m, y3p), (t1, z3), (t0m, xy))
    Y3, X3 = _add((w0, w1), (x3b, x3b))
    return X3, Y3, Z3


def padd_mixed_plain(p, qx, qy):
    """P (projective) + Q (affine, not the identity): RCB15 Algorithm 8,
    a = 0, int64. Complete in P."""
    X1, Y1, Z1 = p
    (sx,) = _add((X1, Y1))
    (sq,) = _add((qx, qy))
    t0, t1, m3, m4, m5 = _mm((X1, qx), (Y1, qy), (sx, sq), (Z1, qy), (Z1, qx))
    a01, t4, t5, t0_2 = _add((t0, t1), (m4, Y1), (m5, X1), (t0, t0))
    (t3,) = _sub((m3, a01))
    (t0_3,) = _add((t0_2, t0))
    bz, y3t = _mul12(Z1, t5)
    (z3t,) = _add((t1, bz))
    (t1m,) = _sub((t1, bz))
    w0, w1, w2, w3, w4, w5 = _mm(
        (t3, t1m), (t4, y3t), (y3t, t0_3), (t1m, z3t), (z3t, t4), (t0_3, t3)
    )
    (X3,) = _sub((w0, w1))
    Y3, Z3 = _add((w2, w3), (w4, w5))
    return X3, Y3, Z3


def pidentity(shape, device, dtype=torch.int32):
    """Identity batch (0 : 1 : 0), coordinates (24, *shape)."""
    zero = torch.zeros((FQ.L,) + tuple(shape), dtype=dtype, device=device)
    one = FQ.one(device).to(dtype).reshape((FQ.L,) + (1,) * len(shape)).expand_as(zero)
    return zero, one.contiguous(), zero.clone()


def pselect(cond, p_true, p_false):
    """Lanewise choice between two point batches (tensor glue on either
    device, as in the JAX package)."""
    return tuple(torch.where(cond[None], a, b) for a, b in zip(p_true, p_false))


# -- the launchers --------------------------------------------------------------


def padd(p, q):
    """Elementwise complete addition of two equal-shape point batches."""
    if kernels.on_cpu(*p, *q):
        return _to32(padd_plain(_to64(p), _to64(q)))
    dev = kernels.check_cuda(*p, *q)
    shape = p[0].shape
    if shape[0] != FQ.L or any(c.shape != shape for c in (*p, *q)):
        raise ValueError("padd: coordinates must share one (24, ...) shape")
    p = tuple(c.contiguous() for c in p)
    q = tuple(c.contiguous() for c in q)
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    n = p[0][0].numel()
    if n:
        kernels.launch(
            "bpt_g1_padd", dev, *(kernels.ptr(c) for c in (*p, *q, *out)), n
        )
        padd.launches += 1
    return out


padd.launches = 0


def pdouble(p):
    """Elementwise complete doubling of a point batch."""
    if kernels.on_cpu(*p):
        return _to32(pdouble_plain(_to64(p)))
    dev = kernels.check_cuda(*p)
    shape = p[0].shape
    if shape[0] != FQ.L or any(c.shape != shape for c in p):
        raise ValueError("pdouble: coordinates must share one (24, ...) shape")
    p = tuple(c.contiguous() for c in p)
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    n = p[0][0].numel()
    if n:
        kernels.launch(
            "bpt_g1_pdouble", dev, *(kernels.ptr(c) for c in (*p, *out)), n
        )
        pdouble.launches += 1
    return out


pdouble.launches = 0


def tree_reduce_plain(p):
    """Plain version of ``tree_reduce``: one ``padd_plain`` a halving level,
    on int64 lanes."""
    n = p[0].shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"tree_reduce: {n} lanes, not a power of two")
    p = _to64(p)
    while n > 1:
        h = n // 2
        p = padd_plain(tuple(c[..., :h] for c in p), tuple(c[..., h:n] for c in p))
        n = h
    return _to32(tuple(c[..., 0] for c in p))


#: threads of a block of the tree kernel at most (csrc/g1.cu, TREE_THREADS)
TREE_THREADS = 256
#: lanes a block takes at least where a set is split over blocks: one warp
TREE_MIN_LANES = 64


def tree_plan(n: int, sets: int, sms: int) -> tuple[int, int]:
    """(B, units) of one ``bpt_g1_tree`` launch over ``sets`` sets of n
    lanes on a card of ``sms`` SMs: B blocks a set, each taking n / B lanes
    at two a thread, as few as fit a block, then more until the blocks fill
    the SMs (down to TREE_MIN_LANES a block); with B = 1, ``units`` sets a
    block. The set's last block takes the B points at two a thread, so
    n / B and B stay within 2 TREE_THREADS (n at most 2^18)."""
    B = 1
    while n // B > 2 * TREE_THREADS:
        B *= 2
    while sets * B < sms and n // B > TREE_MIN_LANES:
        B *= 2
    if B > 2 * TREE_THREADS:
        raise ValueError(f"tree_reduce: {n} lanes a set, more than one launch takes")
    units = min(TREE_THREADS // max(n // B // 2, 1), sets) if B == 1 else 1
    return B, units


def tree_layout(c):
    """(limb stride, lane stride, inner, outer stride, inner stride) that
    put element (l, set s, lane k) of a (24, *batch, n) view at l limb +
    (s // inner) outer + (s % inner) inner_stride + k lane, in elements from
    its first; None when its batch axes do not fold into two strides."""
    axes = []
    for size, stride in zip(c.shape[1:-1], c.stride()[1:-1]):
        if size == 1:
            continue
        if axes and axes[-1][1] == size * stride:
            axes[-1] = (axes[-1][0] * size, stride)
        else:
            axes.append((size, stride))
    if len(axes) > 2:
        return None
    axes = [(1, 0)] * (2 - len(axes)) + axes
    return c.stride(0), c.stride(-1), axes[1][0], axes[0][1], axes[1][1]


def tree_reduce(p):
    """Sum a (24, ..., n) batch of points over the last axis (n a power of
    two) by halving: level s adds lane i + n/2^(s+1) into lane i, the
    order of ``baby_plonk_tpu/ops/g1_vec.py::tree_reduce``. Returns
    (24, ...) coordinates. On the card ONE launch of ``bpt_g1_tree`` a
    call, which reads the caller's view in place where its batch axes fold
    into two strides (else one copy a coordinate)."""
    n = p[0].shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"tree_reduce: {n} lanes, not a power of two")
    if kernels.on_cpu(*p):
        return tree_reduce_plain(p)
    dev = kernels.check_cuda(*p)
    shape = p[0].shape
    if shape[0] != FQ.L or any(c.shape != shape for c in p):
        raise ValueError("tree_reduce: coordinates must share one (24, ..., n) shape")
    layout = tree_layout(p[0])
    if layout is None or any(c.stride() != p[0].stride() for c in p):
        p = tuple(c.contiguous() for c in p)
        layout = tree_layout(p[0])
    out = tuple(torch.empty(shape[:-1], dtype=torch.int32, device=dev) for _ in range(3))
    sets = out[0][0].numel()
    if sets:
        B, units = tree_plan(n, sets, torch.cuda.get_device_properties(dev).multi_processor_count)
        scratch = torch.empty(36 * sets * B + sets if B > 1 else 0, dtype=torch.int32, device=dev)
        kernels.launch("bpt_g1_tree", dev, *(kernels.ptr(c) for c in p), *layout, sets, n, B, units,
                       *(kernels.ptr(c) for c in out), kernels.ptr(scratch) if B > 1 else None)
        tree_reduce.launches += 1
    return out


tree_reduce.launches = 0


def combine_partials(p):
    """Sum (24, ..., k) partial points over the last axis: pad to a power of two with the identity,
    then ``tree_reduce`` (``baby_plonk_tpu/ops/msm.py::_combine_partials``)."""
    k = p[0].shape[-1]
    m = 1
    while m < k:
        m <<= 1
    if m != k:
        ident = pidentity(tuple(p[0].shape[1:-1]) + (m - k,), p[0].device)
        p = tuple(torch.cat([c, e], dim=-1) for c, e in zip(p, ident))
    return tree_reduce(p)


def batch_normalize(p):
    """Projective batch -> affine (x, y) with one batched inversion over the
    flattened batch; the identity (Z = 0) maps to the (0, 0) marker."""
    X, Y, Z = p
    zinv = limbs.batch_inverse(FQ, Z.reshape(FQ.L, -1)).reshape(Z.shape)
    return limbs.mont_mul(FQ, X, zinv), limbs.mont_mul(FQ, Y, zinv)


# -- host <-> device ------------------------------------------------------------


def points_to_device(points, device):
    """list[host G1] -> (X, Y, Z) Montgomery (24, n); one host batch
    normalization, identity -> (0 : 1 : 0)."""
    from ..curves.g1 import G1

    xs, ys, zs = [], [], []
    for aff in G1.batch_normalize(list(points)):
        if aff is None:
            xs.append(0), ys.append(1), zs.append(0)
        else:
            xs.append(aff[0]), ys.append(aff[1]), zs.append(1)
    return tuple(FQ.pack_mont(v, device) for v in (xs, ys, zs))


def points_from_device(p) -> list:
    """(24, n) x3 projective Montgomery -> list[host G1] (exact), one host
    batch inversion."""
    from ..curves.g1 import G1

    X, Y, Z = (FQ.unpack_mont(c.reshape(FQ.L, -1)) for c in p)
    idx = [i for i, z in enumerate(Z) if z]
    prefix = [1]
    for i in idx:
        prefix.append(prefix[-1] * Z[i] % fq.P)
    inv = fq.inv(prefix[-1]) if idx else 1
    out = [G1.identity()] * len(Z)
    for j in range(len(idx) - 1, -1, -1):
        i = idx[j]
        zi = prefix[j] * inv % fq.P
        inv = inv * Z[i] % fq.P
        out[i] = G1.from_affine(X[i] * zi % fq.P, Y[i] * zi % fq.P)
    return out


def point_from_device(p):
    """Single point (X, Y, Z) of shape (24,) -> host G1."""
    return points_from_device(tuple(c.reshape(FQ.L, 1) for c in p))[0]
