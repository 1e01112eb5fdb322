"""Device-resident dense polynomials over Fr (counterpart of
``baby_plonk_tpu/ops/dpoly.py``).

``DPoly`` is duck-type compatible with the host ``protocol.poly.Poly``
(the operator surface the prover uses), with values a (16, n) int32
Montgomery limb tensor on the engine's device. Every field operation is a
``limbs`` launch; the formulations follow the JAX module:

  * monomial x monomial  -> pad to 2^k, NTT, pointwise product, iNTT
  * divide by x^n - 1    -> row-block suffix sums
  * divide by (x - z), evaluation -> power tables and suffix sums
    (``limbs.pow_table``, ``limbs.field_scan``: one kernel each on the card)
"""
from __future__ import annotations

import torch

from ..fields import fr
from ..protocol.poly import Basis
from ..utils.metrics import get_metrics

from . import limbs
from .limbs import FR
from .ntt import ntt_device

Q = fr.Q


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def _add(a, b):
    return limbs.add_mod(FR, a, b)


def _sub(a, b):
    return limbs.sub_mod(FR, a, b)


def _mul(a, b):
    return limbs.mont_mul(FR, a, b)


def scalar(v: int, device) -> torch.Tensor:
    """(16, 1) Montgomery form of a host scalar."""
    return FR.mont_scalar(v, device)


def pow_table(z: torch.Tensor, n: int) -> torch.Tensor:
    """[1, z, ..., z^(n-1)] as (16, n) for a (16, 1) Montgomery z."""
    return limbs.pow_table(FR, z, n)


def reduce_add(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over the last axis (a power of two), keepdim."""
    n = x.shape[-1]
    while n > 1:
        x = _add(x[..., : n // 2], x[..., n // 2 :])
        n //= 2
    return x


def suffix_sum_excl(x: torch.Tensor) -> torch.Tensor:
    """S[k] = sum_{t > k} x[t] along the last axis."""
    return limbs.field_scan(FR, x, "add", reverse=True, exclusive=True)[0]


def pad_to(a: torch.Tensor, n: int) -> torch.Tensor:
    cur = a.shape[-1]
    if cur == n:
        return a
    assert cur < n
    return torch.cat([a, a.new_zeros(a.shape[:-1] + (n - cur,))], dim=-1)


def _debug_asserts() -> bool:
    from ..config import get_config

    return get_config().debug_asserts


class DPoly:
    """Device polynomial; ``vals`` is (16, n) Montgomery limbs."""

    __slots__ = ("vals", "basis")

    def __init__(self, vals: torch.Tensor, basis: Basis):
        self.vals = vals
        self.basis = basis

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def from_ints(values, basis: Basis, device) -> "DPoly":
        with get_metrics().span("dpoly.from_ints"):
            return DPoly(FR.pack_mont(values, device), basis)

    @staticmethod
    def sparse(length: int, entries: dict, basis: Basis, device) -> "DPoly":
        """``length`` values, zero but at ``entries`` (position -> int): zeros
        made on the device and one upload of the k values (``FR.mont_scalars``),
        copied into place a run of adjacent positions at a time."""
        vals = torch.zeros((16, length), dtype=torch.int32, device=device)
        pos = sorted(entries)
        if pos:
            assert 0 <= pos[0] and pos[-1] < length, "sparse entry outside the polynomial"
            packed = FR.mont_scalars([entries[i] for i in pos], device)
            start = 0
            for k in range(1, len(pos) + 1):
                if k == len(pos) or pos[k] != pos[k - 1] + 1:
                    vals[:, pos[start] : pos[k - 1] + 1] = packed[:, start:k]
                    start = k
        return DPoly(vals, basis)

    @staticmethod
    def vanishing(n: int, device) -> "DPoly":
        return DPoly.from_ints([Q - 1] + [0] * (n - 1) + [1], Basis.MONOMIAL, device)

    # -- host boundary ---------------------------------------------------------

    @property
    def values(self) -> list[int]:
        return FR.unpack_mont(self.vals)

    def __len__(self):
        return self.vals.shape[-1]

    @property
    def device(self):
        return self.vals.device

    # -- basis conversion ------------------------------------------------------

    def to_monomial(self) -> "DPoly":
        if self.basis == Basis.MONOMIAL:
            return self
        return DPoly(ntt_device(self.vals, inverse=True), Basis.MONOMIAL)

    def to_lagrange(self, n: int | None = None) -> "DPoly":
        if self.basis == Basis.LAGRANGE:
            return self
        vals = self.vals if n is None else pad_to(self.vals, n)
        return DPoly(ntt_device(vals), Basis.LAGRANGE)

    # -- arithmetic ------------------------------------------------------------

    def __add__(self, other):
        if isinstance(other, int):
            s = scalar(other, self.device)
            if self.basis == Basis.LAGRANGE:
                return DPoly(_add(self.vals, s), self.basis)
            v = self.vals
            return DPoly(torch.cat([_add(v[:, :1], s), v[:, 1:]], dim=-1), self.basis)
        assert self.basis == other.basis, "basis mismatch"
        a, b = self.vals, other.vals
        if self.basis == Basis.LAGRANGE:
            assert a.shape == b.shape, "Lagrange add needs equal domains"
            return DPoly(_add(a, b), self.basis)
        n = max(a.shape[-1], b.shape[-1])
        return DPoly(_add(pad_to(a, n), pad_to(b, n)), self.basis)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, int):
            return self + (-other % Q)
        assert self.basis == other.basis
        a, b = self.vals, other.vals
        if self.basis == Basis.LAGRANGE:
            assert a.shape == b.shape
            return DPoly(_sub(a, b), self.basis)
        n = max(a.shape[-1], b.shape[-1])
        return DPoly(_sub(pad_to(a, n), pad_to(b, n)), self.basis)

    def __mul__(self, other):
        if isinstance(other, int):
            return DPoly(_mul(self.vals, scalar(other, self.device)), self.basis)
        assert self.basis == other.basis
        if self.basis == Basis.LAGRANGE:
            assert self.vals.shape == other.vals.shape
            return DPoly(_mul(self.vals, other.vals), self.basis)
        out_len = self.vals.shape[-1] + other.vals.shape[-1] - 1
        size = _next_pow2(out_len)
        fa = ntt_device(pad_to(self.vals, size))
        fb = ntt_device(pad_to(other.vals, size))
        prod = ntt_device(_mul(fa, fb), inverse=True)
        return DPoly(prod[:, :out_len], Basis.MONOMIAL)

    __rmul__ = __mul__

    def __neg__(self):
        return DPoly(limbs.neg_mod(FR, self.vals), self.basis)

    def rlc(self, other, beta: int, gamma: int):
        return self + other * beta + gamma

    # -- evaluation and division -------------------------------------------------

    def eval(self, x: int) -> int:
        assert self.basis == Basis.MONOMIAL
        size = _next_pow2(self.vals.shape[-1])
        pw = pow_table(scalar(x, self.device), size)
        return FR.unpack_mont(reduce_add(_mul(pad_to(self.vals, size), pw)))[0]

    def divide_by_vanishing(self, n: int, check: bool | None = None) -> "DPoly":
        """Exact division by x^n - 1: q[k] = sum_{t >= 1} N[k + t n]."""
        assert self.basis == Basis.MONOMIAL
        check = _debug_asserts() if check is None else check
        d = self.vals.shape[-1] - 1
        if d < n:
            if check:
                assert all(v == 0 for v in self.values), "not divisible by Z_H"
            return DPoly.from_ints([0], Basis.MONOMIAL, self.device)
        T = (d + n) // n
        rows = pad_to(self.vals, T * n).reshape(16, T, n).unbind(1)
        acc = torch.zeros((16, n), dtype=torch.int32, device=self.device)
        qrows = []
        for t in range(T - 1, 0, -1):
            acc = _add(acc, rows[t])
            qrows.append(acc)
        q = torch.cat(qrows[::-1], dim=-1)[:, : d - n + 1]
        if check:
            rem = _add(rows[0], pad_to(q[:, : min(n, q.shape[-1])], n))
            assert not bool(limbs.to_host(rem.any())), "polynomial not divisible by Z_H"
        return DPoly(q, Basis.MONOMIAL)

    def divide_by_linear(self, z: int, check: bool | None = None) -> "DPoly":
        """Exact division by (x - z): q[k] = z^-(k+1) sum_{t > k} N[t] z^t."""
        assert self.basis == Basis.MONOMIAL
        check = _debug_asserts() if check is None else check
        nlen = self.vals.shape[-1]
        if nlen == 1:
            if check:
                assert self.values == [0], "polynomial not divisible by (x - z)"
            return DPoly.from_ints([0], Basis.MONOMIAL, self.device)
        z %= Q
        assert z != 0, "divide_by_linear expects nonzero z"
        z_inv = pow(z, Q - 2, Q)
        dev = self.device
        s = suffix_sum_excl(_mul(self.vals, pow_table(scalar(z, dev), nlen)))
        q = _mul(_mul(s, pow_table(scalar(z_inv, dev), nlen)), scalar(z_inv, dev))
        if check:
            head = _add(self.vals[:, :1], _mul(scalar(z, dev), q[:, :1]))
            assert not bool(limbs.to_host(head.any())), "polynomial not divisible by (x - z)"
        return DPoly(q[:, : nlen - 1], Basis.MONOMIAL)

    def slice_coeffs(self, start: int, stop: int | None = None) -> "DPoly":
        """Coefficients [start, stop) as a monomial poly (zero-padded)."""
        assert self.basis == Basis.MONOMIAL
        n = self.vals.shape[-1]
        if start >= n:
            width = (stop - start) if stop is not None else 1
            return DPoly(self.vals.new_zeros((16, max(width, 1))), Basis.MONOMIAL)
        v = self.vals[:, start:stop]
        if stop is not None and v.shape[-1] < stop - start:
            v = pad_to(v, stop - start)
        return DPoly(v, Basis.MONOMIAL)

    def scale_domain(self, k: int) -> "DPoly":
        """p(x) -> p(k x): coefficient i scaled by k^i."""
        assert self.basis == Basis.MONOMIAL
        pw = pow_table(scalar(k, self.device), self.vals.shape[-1])
        return DPoly(_mul(self.vals, pw), Basis.MONOMIAL)

    def degree(self) -> int:
        vals = self.values
        i = len(vals)
        while i > 0 and vals[i - 1] == 0:
            i -= 1
        return i - 1

    def __repr__(self):
        return f"DPoly({self.basis.name}, n={self.vals.shape[-1]}, {self.device})"


#: round 4 evaluates in position chunks of this width (a power of two; the
#: JAX package's BPT_EVAL_CHUNK default): a (16, k, 2^19) stack at most,
#: where padding to the next power of two would stack (16, k, 2^21) at 2^20
#: gates
EVAL_CHUNK = 1 << 19


def slice_pad(a: torch.Tensor, lo: int, width: int) -> torch.Tensor:
    """a[..., lo:lo + width], zero-padded on the right to ``width``."""
    return pad_to(a[..., lo : lo + width], width)


def eval_many(polys: list[DPoly], x: int) -> list[int]:
    """Evaluate k monomial DPolys at one point: a stacked multiply and a
    halving sum a position chunk, one host transfer.

    The chunks are W = min(EVAL_CHUNK, the next power of two) positions
    wide, over one power table of width W: p(x) = sum_c x^(c W) p_c(x) with
    p_c the c-th block of W coefficients. ``eval_many.chunks`` counts the
    chunks."""
    assert all(p.basis == Basis.MONOMIAL for p in polys)
    if not polys:
        return []
    dev = polys[0].device
    L = max(len(p) for p in polys)
    W = min(EVAL_CHUNK, _next_pow2(L))
    pw = pow_table(scalar(x, dev), W)[:, None, :]
    acc = None
    for lo in range(0, L, W):
        chunk = torch.stack([slice_pad(p.vals, lo, W) for p in polys], dim=1)  # (16, k, W)
        part = reduce_add(_mul(chunk, pw))
        acc = part if lo == 0 else _add(acc, _mul(part, scalar(pow(x, lo, Q), dev)[:, None, :]))
        eval_many.chunks += 1
    return FR.unpack_mont(acc)


eval_many.chunks = 0
