"""Fr / Fq limb arithmetic: field specs, host codecs, and the elementwise
field operations with their CUDA launchers (``csrc/field.cu``).

Layout, as in ``baby_plonk_tpu/ops/limbs.py``: an element batch is an
int32 tensor (L, *batch) of 16-bit little-endian limbs, limb axis leading;
L = 16 for Fr and 24 for Fq. Field values are canonical Montgomery
residues x*R mod p with R = 2^(16 L) — the JAX package's R, so a
Montgomery value is the same integer in both packages.

Every operation dispatches on where its tensors lie: on the CPU it runs
its plain PyTorch version (int64 lanes on 16-bit limbs; torch's CPU build
has no add, shift, where or gather for uint32/uint64), on a CUDA tensor it
launches the hand-written kernel or raises. The plain versions double as
the reference the kernels are held against on the card.

Kernels (csrc/field.cu): ``bpt_field_op`` / ``bpt_field_select``, the
counterpart of ``mont_mul_pallas`` (baby_plonk_tpu/ops/pallas_kernels.py:43)
and of the XLA elementwise ops of ops/limbs.py (add/sub/neg :325-345,
to/from_mont :812-824); and what ``jax.jit`` compiled into one executable
there and an eager composition would run as a launch a field operation:
``bpt_field_pow`` (``mont_pow_fixed``, limbs.py:842), ``bpt_field_scan``
(``field_scan``; the reference's ``doubling_scan``, :860, stays as the plain
version) and ``bpt_field_pow_table`` (``pow_table``). Field arithmetic is
exact and associative, so a kernel that combines in another order than its
plain version gives the same canonical limbs: all are compared with ``==``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..fields import fq, fr

from . import kernels

MASK = 0xFFFF


# -----------------------------------------------------------------------------
# Field specs and host codecs
# -----------------------------------------------------------------------------


def ints_to_limbs(xs, L: int) -> np.ndarray:
    """list[int] (each < 2^(16 L)) -> (L, n) int32 limb array."""
    nbytes = 2 * L
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(len(xs), L)
    return np.ascontiguousarray(u16.T).astype(np.int32)


def limbs_to_ints(a) -> list[int]:
    """(L, n) limb array (numpy or CPU tensor) -> list[int]."""
    a = np.asarray(a)
    L = a.shape[0]
    buf = np.ascontiguousarray(a.T.astype("<u2")).tobytes()
    nbytes = 2 * L
    return [int.from_bytes(buf[i * nbytes:(i + 1) * nbytes], "little") for i in range(a.shape[1])]


class FieldSpec:
    """A prime field for the limb kernels: modulus, limb count and the
    Montgomery constants R = 2^(16 L) mod p, R^2 mod p and
    N' = -p^-1 mod 2^(16 L) (re-derived here; the JAX FieldSpec lives in a
    module that imports JAX). ``cid`` selects the field in the CUDA
    library (0 = Fr, 1 = Fq)."""

    def __init__(self, modulus: int, L: int, cid: int):
        assert modulus < 1 << (16 * L - 1), "top limb must have headroom"
        self.modulus = modulus
        self.L = L
        self.cid = cid
        self.R = (1 << (16 * L)) % modulus
        self.R2 = self.R * self.R % modulus
        self.R_INV = pow(self.R, -1, modulus)
        self.NPRIME = (-pow(modulus, -1, 1 << (16 * L))) % (1 << (16 * L))
        self._consts: dict = {}

    def const(self, value: int, device, dtype=torch.int32) -> torch.Tensor:
        """(L, 1) limbs of the integer ``value`` on ``device`` (cached)."""
        key = (value, str(device), dtype)
        t = self._consts.get(key)
        if t is None:
            t = torch.from_numpy(ints_to_limbs([value], self.L)).to(device=device, dtype=dtype)
            self._consts[key] = t
        return t

    def one(self, device) -> torch.Tensor:
        """Montgomery form of 1, (L, 1)."""
        return self.const(self.R, device)

    def mont_scalar(self, x: int, device) -> torch.Tensor:
        """Montgomery form of one host int as (L, 1) (host-side conversion of
        a protocol scalar, as the JAX package's pack_mont of a scalar). Not
        cached: every proof brings new challenges."""
        mont = x % self.modulus * self.R % self.modulus
        return torch.from_numpy(ints_to_limbs([mont], self.L)).to(device)

    # -- tensor codecs ----------------------------------------------------------

    def pack_raw(self, xs, device) -> torch.Tensor:
        """list[int] -> (L, n) limbs, no Montgomery scaling (MSM scalars)."""
        return torch.from_numpy(ints_to_limbs([x % self.modulus for x in xs], self.L)).to(device)

    def pack_mont(self, xs, device) -> torch.Tensor:
        """list[int] -> (L, n) Montgomery limbs (``to_mont`` on the device)."""
        return to_mont(self, self.pack_raw(xs, device))

    def unpack_raw(self, a: torch.Tensor) -> list[int]:
        return limbs_to_ints(a.reshape(self.L, -1).cpu().numpy())

    def unpack_mont(self, a: torch.Tensor) -> list[int]:
        """(L, ...) Montgomery limbs -> canonical ints (``from_mont`` on the
        device, then the host codec), flattened over the batch."""
        return self.unpack_raw(from_mont(self, a.reshape(self.L, -1)))


FR = FieldSpec(fr.Q, 16, 0)
FQ = FieldSpec(fq.P, 24, 1)


# -----------------------------------------------------------------------------
# Plain versions (int64 lanes on 16-bit limbs)
# -----------------------------------------------------------------------------

def _norm(c: torch.Tensor) -> torch.Tensor:
    """Propagate carries and borrows through int64 limb columns (K, ...):
    limbs 0..K-2 end in [0, 2^16), the top limb keeps the signed rest.
    Arithmetic shift floors, so negative columns borrow correctly."""
    while True:
        hi = c[:-1] >> 16
        if not bool(hi.any()):
            return c
        c = c.clone()
        c[:-1] &= MASK
        c[1:] += hi


def _cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Raw column sums of the schoolbook product: a (La, N), b (Lb, N or 1)
    -> (La + Lb, N) with column k = sum_{i+j=k} a_i b_j (not normalized).
    Row i of the (La, Lb) product table is shifted right by i with one pad
    and a reshape (rows of Lb + La + 1 read back as rows of Lb + La)."""
    La, Lb = a.shape[0], b.shape[0]
    prod = a.unsqueeze(1) * b.unsqueeze(0)  # (La, Lb, N)
    N = prod.shape[2]
    skew = torch.nn.functional.pad(prod, (0, 0, 0, La + 1))
    skew = skew.reshape(La * (Lb + La + 1), N)[: La * (Lb + La)]
    return skew.reshape(La, Lb + La, N).sum(0)


def _c64(spec: FieldSpec, value: int, device, rows: int | None = None) -> torch.Tensor:
    rows = spec.L if rows is None else rows
    t = spec.const(value, device, torch.int64)
    if rows > spec.L:
        t = torch.cat([t, torch.zeros((rows - spec.L, 1), dtype=torch.int64, device=device)])
    return t


def _lead(x: torch.Tensor, nd: int) -> torch.Tensor:
    """(L, *batch) -> (L, 1, ..., 1, *batch) with ``nd`` batch dims: the limb
    axis leads and batch dims broadcast right-aligned, as in the JAX package."""
    return x.reshape((x.shape[0],) + (1,) * (nd - x.dim() + 1) + tuple(x.shape[1:]))


def broadcast_batch(*shapes) -> tuple:
    """Right-aligned broadcast of batch shapes (``torch.broadcast_shapes``
    costs ~0.5 ms a call on the CPU, more than the arithmetic here)."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, d in enumerate(s, nd - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def _flat(spec: FieldSpec, *xs):
    batch = broadcast_batch(*(x.shape[1:] for x in xs))
    shape = (spec.L,) + tuple(batch)
    return shape, [
        _lead(x.to(torch.int64), len(batch)).expand(shape).reshape(spec.L, -1) for x in xs
    ]


def _reduce_once(spec: FieldSpec, s: torch.Tensor) -> torch.Tensor:
    """s (limbs, value < 2p, not necessarily normalized) -> s mod p, L
    limbs: s and s - p are normalized together, the sign of s - p picks."""
    both = _norm(torch.stack([s, s - _c64(spec, spec.modulus, s.device, s.shape[0])], 1))
    s, d = both[:, 0], both[:, 1]
    return torch.where(d[-1:] < 0, s, d)[: spec.L]


def _mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p (canonical), int64 limbs in and out.
    t = a b; m = (t mod R) N' mod R; u = (t + m p) / R < 2p."""
    L = spec.L
    shape, (A, B) = _flat(spec, a, b)
    t = _norm(_cols(A, B))  # (2L, N), t < p^2 < R^2
    m = _norm(_cols(t[:L], _c64(spec, spec.NPRIME, a.device))[:L])
    m[-1] &= MASK  # mod R
    mp = _norm(_cols(m, _c64(spec, spec.modulus, a.device)))
    # t mod R and (m p) mod R sum to 0 or R; the carry into the high half
    # is 1 exactly when t mod R is nonzero
    u = torch.cat([t[L:] + mp[L:], torch.zeros_like(t[:1])])
    u[0] += (t[:L] != 0).any(0)
    return _reduce_once(spec, u).reshape(shape)


def _add_plain(spec, a, b):
    shape, (A, B) = _flat(spec, a, b)
    return _reduce_once(spec, torch.cat([A + B, torch.zeros_like(A[:1])])).reshape(shape)


def _sub_plain(spec, a, b):
    shape, (A, B) = _flat(spec, a, b)
    d = A - B
    both = _norm(torch.stack([d, d + _c64(spec, spec.modulus, A.device)], 1))
    return torch.where(both[-1:, 0] < 0, both[:, 1], both[:, 0]).reshape(shape)


def _neg_plain(spec, a):
    shape, (A,) = _flat(spec, a)
    d = _norm(_c64(spec, spec.modulus, A.device) - A)
    return torch.where((A == 0).all(0, keepdim=True), A, d).reshape(shape)


# -----------------------------------------------------------------------------
# Dispatching wrappers
# -----------------------------------------------------------------------------

_OP_MUL, _OP_ADD, _OP_SUB, _OP_NEG, _OP_TO_MONT, _OP_FROM_MONT, _OP_SQR = range(7)


def _bcast(op_batch, out_batch):
    """(div, mod) such that output element i reads operand element
    (i // div) % mod, or None when the broadcast is not of the form
    (broadcast dims, operand dims, broadcast dims)."""
    op = (1,) * (len(out_batch) - len(op_batch)) + tuple(op_batch)
    kinds = [("m" if o == s else "b", s) for o, s in zip(op, out_batch) if s != 1]
    i = 0
    while i < len(kinds) and kinds[i][0] == "b":
        i += 1
    j = len(kinds)
    while j > i and kinds[j - 1][0] == "b":
        j -= 1
    if any(k == "b" for k, _ in kinds[i:j]):
        return None
    return math.prod(s for _, s in kinds[j:]), math.prod(s for _, s in kinds[i:j])


def _operand(L: int, x, out_batch):
    if x.shape[0] != L:
        raise ValueError(f"expected {L} limbs, got shape {tuple(x.shape)}")
    bc = _bcast(x.shape[1:], out_batch)
    if bc is None:
        x = x.expand((L,) + tuple(out_batch))
        bc = (1, math.prod(out_batch))
    return x.contiguous(), bc


def _launch_op(counter, spec: FieldSpec, op: int, a, b=None):
    xs = (a,) if b is None else (a, b)
    dev = kernels.check_cuda(*xs)
    if all(x.shape == a.shape and x.is_contiguous() for x in xs) and a.shape[0] == spec.L:
        # equal contiguous shapes: no broadcast map to work out
        out = torch.empty_like(a)
        n = out[0].numel()
        b = a if b is None else b
        a_div = b_div = 1
        a_mod = b_mod = n
    else:
        out_batch = broadcast_batch(*(x.shape[1:] for x in xs))
        a, (a_div, a_mod) = _operand(spec.L, a, out_batch)
        if b is None:
            b, b_div, b_mod = a, a_div, a_mod
        else:
            b, (b_div, b_mod) = _operand(spec.L, b, out_batch)
        out = torch.empty((spec.L,) + tuple(out_batch), dtype=torch.int32, device=dev)
        n = math.prod(out_batch)
    if n:
        kernels.launch(
            "bpt_field_op", dev, spec.cid, op,
            kernels.ptr(a), a_div, a_mod, kernels.ptr(b), b_div, b_mod,
            kernels.ptr(out), n,
        )
        counter.launches += 1
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * R^-1 mod p, broadcasting over the batch."""
    if kernels.on_cpu(a, b):
        return _mont_mul_plain(spec, a, b).to(torch.int32)
    return _launch_op(mont_mul, spec, _OP_MUL, a, b)


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery square a * a * R^-1 mod p: the device's dedicated square
    (csrc/field.cuh::sqr, which the point doubling and the table
    normalization run), exposed so that it can be held against the product."""
    if kernels.on_cpu(a):
        return _mont_mul_plain(spec, a, a).to(torch.int32)
    return _launch_op(mont_sqr, spec, _OP_SQR, a)


def add_mod(spec: FieldSpec, a, b):
    if kernels.on_cpu(a, b):
        return _add_plain(spec, a, b).to(torch.int32)
    return _launch_op(add_mod, spec, _OP_ADD, a, b)


def sub_mod(spec: FieldSpec, a, b):
    if kernels.on_cpu(a, b):
        return _sub_plain(spec, a, b).to(torch.int32)
    return _launch_op(sub_mod, spec, _OP_SUB, a, b)


def neg_mod(spec: FieldSpec, a):
    if kernels.on_cpu(a):
        return _neg_plain(spec, a).to(torch.int32)
    return _launch_op(neg_mod, spec, _OP_NEG, a)


def to_mont(spec: FieldSpec, a):
    """Canonical residue -> Montgomery form (a * R^2 * R^-1)."""
    if kernels.on_cpu(a):
        return _mont_mul_plain(spec, a, _c64(spec, spec.R2, a.device)).to(torch.int32)
    return _launch_op(to_mont, spec, _OP_TO_MONT, a)


def from_mont(spec: FieldSpec, a):
    """Montgomery form -> canonical residue (a * 1 * R^-1)."""
    if kernels.on_cpu(a):
        return _mont_mul_plain(spec, a, _c64(spec, 1, a.device)).to(torch.int32)
    return _launch_op(from_mont, spec, _OP_FROM_MONT, a)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane select: cond (*batch) bool -> a where true else b (limb axis
    leads; a, b and cond broadcast over the batch)."""
    if kernels.on_cpu(cond, a, b):
        nd = max(cond.dim(), a.dim() - 1, b.dim() - 1)
        return torch.where(_lead(cond[None], nd), _lead(a, nd), _lead(b, nd))
    dev = kernels.check_cuda(a, b)
    kernels.check_cuda(cond, dtype=torch.bool)
    L = a.shape[0]
    if b.shape[0] != L:
        raise ValueError("select: limb counts differ")
    out_batch = broadcast_batch(cond.shape, a.shape[1:], b.shape[1:])
    bc = _bcast(cond.shape, out_batch)
    if bc is None:
        cond, bc = cond.expand(out_batch), (1, math.prod(out_batch))
    cond = cond.contiguous()
    a, (a_div, a_mod) = _operand(L, a, out_batch)
    b, (b_div, b_mod) = _operand(L, b, out_batch)
    out = torch.empty((L,) + tuple(out_batch), dtype=torch.int32, device=dev)
    n = math.prod(out_batch)
    if n:
        kernels.launch(
            "bpt_field_select", dev, L, kernels.ptr(cond), bc[0], bc[1],
            kernels.ptr(a), a_div, a_mod, kernels.ptr(b), b_div, b_mod,
            kernels.ptr(out), n,
        )
        select.launches += 1
    return out


for _fn in (mont_mul, mont_sqr, add_mod, sub_mod, neg_mod, to_mont, from_mont, select):
    _fn.launches = 0


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(0)


# -----------------------------------------------------------------------------
# Power, scans, power table, batched inverse
# -----------------------------------------------------------------------------


_POW_WORDS = 12  # exponent words the kernel takes (384 bits)


def _mont_pow_plain(spec: FieldSpec, a, exponent: int) -> torch.Tensor:
    """Plain version of ``mont_pow_fixed``: left-to-right square-and-multiply,
    one ``_mont_mul_plain`` a step (exponent > 0); int64 limbs out."""
    r = a
    for bit in bin(exponent)[3:]:
        r = _mont_mul_plain(spec, r, r)
        if bit == "1":
            r = _mont_mul_plain(spec, r, a)
    return r


def mont_pow_fixed(spec: FieldSpec, a, exponent: int, plain: bool = False):
    """a^exponent per lane (Montgomery in/out) for one exponent >= 0.
    On a CUDA tensor ONE launch of ``bpt_field_pow`` (square-and-multiply
    inside the thread) where the reference's scan over the exponent bits
    (limbs.py:842) was one executable. Bound: operations, a square a bit
    and a product a set bit; on one lane a latency chain. ``plain`` runs
    the plain version whatever the device."""
    if exponent == 0:
        return spec.one(a.device).expand(a.shape).to(a.dtype)
    if plain or kernels.on_cpu(a):
        return _mont_pow_plain(spec, a, exponent).to(a.dtype)
    dev = kernels.check_cuda(a)
    if a.shape[0] != spec.L or exponent >> (32 * _POW_WORDS):
        raise ValueError(f"mont_pow_fixed: shape {tuple(a.shape)}, exponent of {exponent.bit_length()} bits")
    a = a.contiguous()
    out = torch.empty_like(a)
    n = out[0].numel()
    if n:
        words = (ctypes.c_uint * _POW_WORDS)(*((exponent >> (32 * i)) & 0xFFFFFFFF for i in range(_POW_WORDS)))
        kernels.launch("bpt_field_pow", dev, spec.cid, kernels.ptr(a), kernels.ptr(out), n,
                       words, _POW_WORDS)
        mont_pow_fixed.launches += 1
    return out


def doubling_scan(x: torch.Tensor, combine, identity: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-combine along the last axis (Hillis–Steele: log2 n
    full-width combines, the shifted operand filled with ``identity``, an
    (L, 1) tensor): the reference's formulation, and the plain version of
    ``field_scan``."""
    n = x.shape[-1]
    identity = identity.to(x.dtype).reshape((identity.shape[0],) + (1,) * (x.dim() - 1))
    k = 1
    while k < n:
        pad = identity.expand(x.shape[:-1] + (k,))
        x = combine(x, torch.cat([pad, x[..., :-k]], dim=-1))
        k <<= 1
    return x


_SCAN_OPS = {"mul": 0, "add": 1}
_SCAN_TILE = 256  # csrc/field.cu::SCAN_THREADS


def _scan_plain(spec: FieldSpec, x, op: str, reverse: bool, exclusive: bool):
    """Plain version of ``field_scan``: ``doubling_scan`` between the flips
    and the shift by one that the kernel takes as flags. (out, total), int64."""
    if op == "mul":
        combine, identity = (lambda p, q: _mont_mul_plain(spec, p, q)), _c64(spec, spec.R, x.device)
    else:
        combine, identity = (lambda p, q: _add_plain(spec, p, q)), _c64(spec, 0, x.device)
    y = x.to(torch.int64)
    inc = doubling_scan(y.flip(-1) if reverse else y, combine, identity)
    total = inc[..., -1:]
    if exclusive:
        first = _lead(identity, x.dim() - 1).expand(x.shape[:-1] + (1,))
        inc = torch.cat([first, inc[..., :-1]], dim=-1)
    return (inc.flip(-1) if reverse else inc), total


def field_scan(spec: FieldSpec, x: torch.Tensor, op: str, reverse: bool = False,
               exclusive: bool = False, plain: bool = False):
    """Prefix product (``op`` "mul", Montgomery) or prefix sum ("add") along
    the last axis of (L, *batch, n). ``reverse``: suffix scan (element k
    combines x[k..n-1]); ``exclusive``: element k leaves x[k] out (the
    identity at the open end). Returns (out, total) with total (L, *batch, 1)
    the combination of the whole axis.

    On a CUDA tensor ``bpt_field_scan``: n work in one pass over tiles of 256
    (three small launches, one when n <= 256) where the reference's
    ``doubling_scan`` (limbs.py:860, chosen there for the TPU's tile padding)
    makes log2 n full-width passes; the flip and the shift are index maps in
    the kernel, not tensor copies. Bound: bytes for the sum, one product an
    element for the product. ``plain`` runs the plain version whatever the
    device."""
    if plain or kernels.on_cpu(x):
        out, total = _scan_plain(spec, x, op, reverse, exclusive)
        return out.to(x.dtype), total.to(x.dtype)
    dev = kernels.check_cuda(x)
    if x.shape[0] != spec.L or x.dim() < 2:
        raise ValueError(f"field_scan: bad shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("field_scan: empty operand")
    x = x.contiguous()
    n = x.shape[-1]
    rows = x[0].numel() // n
    out = torch.empty_like(x)
    total = torch.empty(x.shape[:-1] + (1,), dtype=torch.int32, device=dev)
    tiles = -(-n // _SCAN_TILE)
    scratch = torch.empty((2, spec.L, rows, tiles), dtype=torch.int32, device=dev) if tiles > 1 else None
    kernels.launch(
        "bpt_field_scan", dev, spec.cid, _SCAN_OPS[op], kernels.ptr(x), kernels.ptr(out), kernels.ptr(total),
        kernels.ptr(scratch[0]) if tiles > 1 else None, kernels.ptr(scratch[1]) if tiles > 1 else None,
        rows, n, int(reverse), int(exclusive),
    )
    field_scan.launches += 1
    return out, total


def _pow_table_plain(spec: FieldSpec, z: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of ``pow_table``: the doubling scan of [1, z, z, ...]."""
    one = _c64(spec, spec.R, z.device)
    if n == 1:
        return one.clone()
    seq = torch.cat([one, z.to(torch.int64).expand(spec.L, n - 1)], dim=-1)
    return doubling_scan(seq, lambda p, q: _mont_mul_plain(spec, p, q), one)


def pow_table(spec: FieldSpec, z: torch.Tensor, n: int, plain: bool = False) -> torch.Tensor:
    """[1, z, ..., z^(n-1)] as (L, n) for an (L, 1) Montgomery z. On a CUDA
    tensor ``bpt_field_pow_table``, a kernel of its own rather than the scan
    of a broadcast operand: each thread raises z to its first index by
    square-and-multiply and walks on from there, so nothing of size n is
    read. Bound: bytes (n elements written)."""
    if z.shape != (spec.L, 1) or n < 1:
        raise ValueError(f"pow_table: z of shape {tuple(z.shape)}, n = {n}")
    if plain or kernels.on_cpu(z):
        return _pow_table_plain(spec, z, n).to(z.dtype)
    dev = kernels.check_cuda(z)
    out = torch.empty((spec.L, n), dtype=torch.int32, device=dev)
    kernels.launch("bpt_field_pow_table", dev, spec.cid, kernels.ptr(z.contiguous()), kernels.ptr(out), n)
    pow_table.launches += 1
    return out


for _fn in (mont_pow_fixed, field_scan, pow_table):
    _fn.launches = 0


def batch_inverse(spec: FieldSpec, a: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Elementwise inverse over the last axis (Montgomery in/out) with one
    field inversion: inv(a_k) = (prefix before k) (suffix after k) / total,
    two exclusive scans and one power; zeros map to zero. ``plain`` runs the
    plain versions whatever the device (a reference on the card)."""
    if plain:
        mul = lambda x, y: _mont_mul_plain(spec, x, y)
        sel = lambda c, x, y: torch.where(c[None], x, _lead(y, x.dim() - 1))
    else:
        mul = lambda x, y: mont_mul(spec, x, y)
        sel = select
    one = spec.one(a.device).to(a.dtype)
    nz = ~is_zero(a)
    safe = sel(nz, a, one)
    pre, total = field_scan(spec, safe, "mul", exclusive=True, plain=plain)
    suf, _ = field_scan(spec, safe, "mul", reverse=True, exclusive=True, plain=plain)
    inv_total = mont_pow_fixed(spec, total, spec.modulus - 2, plain=plain)
    out = mul(mul(pre, inv_total), suf)
    return sel(nz, out, torch.zeros_like(out))
