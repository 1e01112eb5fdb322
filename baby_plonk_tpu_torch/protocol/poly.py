"""Dense polynomials over Fr in Lagrange (evaluation) or Monomial basis.

Host-side exact engine with O(n log n) algorithms throughout — the
functional equivalent of the reference's src/polynomial.rs + src/utils.rs,
*not* a port: the reference uses an O(n^2) matrix DFT (utils.rs:63-129),
schoolbook long division (polynomial.rs:314-380) and per-element
inversions; we use iterative radix-2 NTT, special-form divisors and batch
inversion. Known reference bugs intentionally NOT replicated: Lagrange
``Sub<Scalar>`` adding instead of subtracting (polynomial.rs:126-129),
Lagrange×Lagrange ``todo!()`` (polynomial.rs:274-276).

The device engine (baby_plonk_tpu_torch.ops) implements the same contract on
device; this module is its correctness oracle.
"""
from __future__ import annotations

import enum

from ..fields import fr

Q = fr.Q


class Basis(enum.Enum):
    LAGRANGE = 1
    MONOMIAL = 2


def ntt(values: list[int], inverse: bool = False) -> list[int]:
    """In-order radix-2 NTT over the 2-adic subgroup of Fr.

    Matches the *function* computed by the reference's matrix DFT
    (utils.rs:63-81): forward output X_j = sum_i x_i w^(ij) with
    w = ROOT_OF_UNITY^(2^32/n); inverse uses w^-1 and scales by n^-1
    (utils.rs:106-129).
    """
    n = len(values)
    assert n & (n - 1) == 0, "NTT size must be a power of two"
    if n == 1:
        return list(values)
    a = list(values)
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    root = fr.root_of_unity(n)
    if inverse:
        root = pow(root, Q - 2, Q)
    # precompute stage twiddles
    length = 2
    while length <= n:
        w_len = pow(root, n // length, Q)
        half = length // 2
        w_pows = [1] * half
        for i in range(1, half):
            w_pows[i] = w_pows[i - 1] * w_len % Q
        for start in range(0, n, length):
            for i in range(half):
                u = a[start + i]
                v = a[start + i + half] * w_pows[i] % Q
                a[start + i] = (u + v) % Q
                a[start + i + half] = (u - v) % Q
        length <<= 1
    if inverse:
        n_inv = pow(n, Q - 2, Q)
        a = [x * n_inv % Q for x in a]
    return a


def i_ntt(values: list[int]) -> list[int]:
    return ntt(values, inverse=True)


class Poly:
    """values: list of canonical Fr ints; basis: LAGRANGE or MONOMIAL."""

    __slots__ = ("values", "basis")

    def __init__(self, values: list[int], basis: Basis):
        self.values = [v % Q for v in values]
        self.basis = basis

    # -- basis conversion -----------------------------------------------------

    def to_monomial(self) -> "Poly":
        if self.basis == Basis.MONOMIAL:
            return self
        return Poly(i_ntt(self.values), Basis.MONOMIAL)

    def to_lagrange(self, n: int | None = None) -> "Poly":
        if self.basis == Basis.LAGRANGE:
            return self
        vals = self.values
        if n is not None:
            assert n >= len(vals) or all(v == 0 for v in vals[n:])
            vals = (vals + [0] * n)[:n]
        return Poly(ntt(vals), Basis.LAGRANGE)

    # -- arithmetic -------------------------------------------------------------

    def _check(self, other: "Poly"):
        assert self.basis == other.basis, "basis mismatch"

    def __add__(self, other):
        if isinstance(other, int):
            if self.basis == Basis.LAGRANGE:
                return Poly([(v + other) % Q for v in self.values], self.basis)
            vals = list(self.values) or [0]
            vals[0] = (vals[0] + other) % Q
            return Poly(vals, self.basis)
        self._check(other)
        a, b = self.values, other.values
        if len(a) < len(b):
            a, b = b, a
        if self.basis == Basis.LAGRANGE:
            assert len(self.values) == len(other.values), "Lagrange add needs equal domains"
        out = list(a)
        for i, v in enumerate(b):
            out[i] = (out[i] + v) % Q
        return Poly(out, self.basis)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, int):
            return self + (-other % Q)
        return self + (other * (Q - 1))

    def __mul__(self, other):
        if isinstance(other, int):
            return Poly([v * other % Q for v in self.values], self.basis)
        self._check(other)
        if self.basis == Basis.LAGRANGE:
            assert len(self.values) == len(other.values)
            return Poly(
                [x * y % Q for x, y in zip(self.values, other.values)], Basis.LAGRANGE
            )
        # monomial: NTT-based product at the next power-of-two domain
        a = _trim(self.values)
        b = _trim(other.values)
        if not a or not b:
            return Poly([0], Basis.MONOMIAL)
        out_len = len(a) + len(b) - 1
        size = 1
        while size < out_len:
            size <<= 1
        fa = ntt(a + [0] * (size - len(a)))
        fb = ntt(b + [0] * (size - len(b)))
        prod = i_ntt([x * y % Q for x, y in zip(fa, fb)])
        return Poly(prod[:out_len], Basis.MONOMIAL)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (Q - 1)

    def __eq__(self, other):
        if not isinstance(other, Poly):
            return NotImplemented
        if self.basis != other.basis:
            return False
        a, b = _trim(self.values), _trim(other.values)
        return a == b

    # -- evaluation & division --------------------------------------------------

    def eval(self, x: int) -> int:
        """Horner evaluation (monomial basis). Equivalent to polynomial.rs:34-45."""
        assert self.basis == Basis.MONOMIAL
        acc = 0
        for c in reversed(self.values):
            acc = (acc * x + c) % Q
        return acc

    def __divmod__(self, other: "Poly"):
        """General division with remainder over Fr (monomial basis):
        self = q * other + r, deg r < deg other. Schoolbook — the general
        surface the reference's ``Div`` exposes (polynomial.rs:314-380,
        which panics on a nonzero remainder; use ``/`` for that exact
        form). The protocol itself never calls this: the hot paths use
        the specialized exact forms (divide_by_vanishing's linear
        recurrence, divide_by_linear's synthetic division, NTT multiply),
        so O(deg n * deg q) host arithmetic here is a deliberate
        fallback, not a bottleneck."""
        assert self.basis == Basis.MONOMIAL and other.basis == Basis.MONOMIAL
        num = list(_trim(self.values))
        den = _trim(other.values)
        assert den and den[-1] != 0, "division by zero polynomial"
        dq = len(den) - 1
        if len(num) - 1 < dq:
            return Poly([0], Basis.MONOMIAL), Poly(num or [0], Basis.MONOMIAL)
        inv_lead = pow(den[-1], Q - 2, Q)
        q = [0] * (len(num) - dq)
        for j in range(len(num) - 1, dq - 1, -1):
            c = num[j] * inv_lead % Q
            q[j - dq] = c
            if c:
                for i, d in enumerate(den):
                    num[j - dq + i] = (num[j - dq + i] - c * d) % Q
        rem = _trim(num[:dq])
        return Poly(q, Basis.MONOMIAL), Poly(rem or [0], Basis.MONOMIAL)

    def __truediv__(self, other: "Poly") -> "Poly":
        """EXACT division — asserts a zero remainder, matching the
        reference's panicking ``Div`` (polynomial.rs:368-379)."""
        q, r = divmod(self, other)
        assert r.values == [0], "polynomial division leaves a remainder"
        return q

    def divide_by_vanishing(self, n: int) -> "Poly":
        """Exact division by Z_H = x^n - 1 via the linear recurrence
        q_{j-n} = N_j + q_j (high to low); asserts exactness."""
        assert self.basis == Basis.MONOMIAL
        num = _trim(self.values)
        d = len(num) - 1
        if d < n:
            assert all(v == 0 for v in num), "not divisible by Z_H"
            return Poly([0], Basis.MONOMIAL)
        q = [0] * (d - n + 1)
        for j in range(d, n - 1, -1):
            q_j = q[j] if j < len(q) else 0
            q[j - n] = (num[j] + q_j) % Q
        # remainder check: N_j == -q_j for j < n
        for j in range(n):
            q_j = q[j] if j < len(q) else 0
            assert num[j] == (-q_j) % Q, "polynomial not divisible by Z_H"
        return Poly(q, Basis.MONOMIAL)

    def divide_by_linear(self, z: int) -> "Poly":
        """Exact division by (x - z) via synthetic (Ruffini) division."""
        assert self.basis == Basis.MONOMIAL
        num = _trim(self.values)
        if not num:
            return Poly([0], Basis.MONOMIAL)
        q = [0] * (len(num) - 1)
        acc = 0
        for j in range(len(num) - 1, 0, -1):
            acc = (num[j] + acc * z) % Q
            q[j - 1] = acc
        rem = (num[0] + acc * z) % Q
        assert rem == 0, "polynomial not divisible by (x - z)"
        return Poly(q, Basis.MONOMIAL)

    def scale_domain(self, k: int) -> "Poly":
        """p(x) -> p(k*x): multiply coefficient i by k^i.

        Used for z(wx) (reference's monomial_z_to_z_omega, prover.rs:661-674).
        """
        assert self.basis == Basis.MONOMIAL
        out = []
        kp = 1
        for c in self.values:
            out.append(c * kp % Q)
            kp = kp * k % Q
        return Poly(out, Basis.MONOMIAL)

    def rlc(self, other: "Poly", beta: int, gamma: int) -> "Poly":
        """self + other*beta + gamma (utils.rs:169-175)."""
        return self + other * beta + gamma

    def slice_coeffs(self, start: int, stop: int | None = None) -> "Poly":
        """Coefficient range [start, stop) as a monomial poly (zero-padded
        if the range extends past the stored length)."""
        assert self.basis == Basis.MONOMIAL
        vals = self.values[start:stop]
        if stop is not None and len(vals) < stop - start:
            vals = vals + [0] * (stop - start - len(vals))
        return Poly(vals or [0], Basis.MONOMIAL)

    def __len__(self):
        return len(self.values)

    def degree(self) -> int:
        assert self.basis == Basis.MONOMIAL
        t = _trim(self.values)
        return len(t) - 1 if t else -1

    def __repr__(self):
        return f"Poly({self.basis.name}, n={len(self.values)})"


def _trim(values: list[int]) -> list[int]:
    i = len(values)
    while i > 0 and values[i - 1] == 0:
        i -= 1
    return values[:i]


def vanishing_poly(n: int) -> Poly:
    """Z_H = x^n - 1 in monomial basis (prover.rs:220-226)."""
    vals = [0] * (n + 1)
    vals[0] = Q - 1
    vals[n] = 1
    return Poly(vals, Basis.MONOMIAL)


def rlc_scalar(a: int, b: int, beta: int, gamma: int) -> int:
    """a + b*beta + gamma (utils.rs:164-168)."""
    return (a + b * beta + gamma) % Q
