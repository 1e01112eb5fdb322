"""Extension-field tower Fp2 -> Fp6 -> Fp12 for BLS12-381 (host-side exact).

Tower layout (matches the reference's vendored curve library semantically):
  Fp2  = Fp[u]  / (u^2 + 1)                (lib/bls12_381/src/fp2.rs:11)
  Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1  (lib/bls12_381/src/fp6.rs:12)
  Fp12 = Fp6[w] / (w^2 - v)                (lib/bls12_381/src/fp12.rs:13)

Host-side only (pairing / verifier path, not a throughput component). All
implementations are written from the mathematical definitions; Frobenius
coefficients are computed at import time rather than hardcoded.
"""
from __future__ import annotations

from . import fq

P = fq.P


class Fp2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fp2":
        return Fp2(0, 0)

    @staticmethod
    def one() -> "Fp2":
        return Fp2(1, 0)

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __add__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fp2") -> "Fp2":
        return Fp2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fp2":
        return Fp2(-self.c0, -self.c1)

    def __mul__(self, o: "Fp2") -> "Fp2":
        # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0 % P
        t1 = a1 * b1 % P
        return Fp2(t0 - t1, (a0 + a1) * (b0 + b1) - t0 - t1)

    def mul_fp(self, k: int) -> "Fp2":
        return Fp2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fp2":
        a0, a1 = self.c0, self.c1
        return Fp2((a0 + a1) * (a0 - a1), 2 * a0 * a1)

    def mul_by_nonresidue(self) -> "Fp2":
        """Multiply by xi = u + 1 (fp2.rs:156-163)."""
        return Fp2(self.c0 - self.c1, self.c0 + self.c1)

    def conjugate(self) -> "Fp2":
        return Fp2(self.c0, -self.c1)

    frobenius = conjugate

    def inv(self) -> "Fp2":
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        ninv = fq.inv(norm)
        return Fp2(self.c0 * ninv, -self.c1 * ninv)

    def pow(self, e: int) -> "Fp2":
        result, base = Fp2.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def sqrt(self) -> "Fp2 | None":
        """Square root in Fp2 (complex method, p ≡ 3 mod 4; cf. fp2.rs:245-293)."""
        if self.is_zero():
            return Fp2.zero()
        # a^((p-2)/4)? Use: a1 = a^((p-3)/4); x0 = a1*a; alpha = a1*x0
        a1 = self.pow((P - 3) // 4)
        x0 = a1 * self
        alpha = a1 * x0
        if alpha == Fp2(P - 1, 0):
            out = Fp2(-x0.c1, x0.c0)  # i * x0
        else:
            b = (alpha + Fp2.one()).pow((P - 1) // 2)
            out = b * x0
        if out.square() == self:
            return out
        return None

    def lexicographically_largest(self) -> bool:
        """fp2.rs convention: c1 largest, or c1 == 0 and c0 largest."""
        return fq.lexicographically_largest(self.c1) or (
            self.c1 == 0 and fq.lexicographically_largest(self.c0)
        )

    def __repr__(self):
        return f"Fp2({hex(self.c0)}, {hex(self.c1)})"


XI = Fp2(1, 1)  # the Fp6 non-residue v^3 = xi = u + 1

# Frobenius coefficients, computed (not hardcoded) at import.
# Fp6: c1 coefficient gamma1 = xi^((p-1)/3), c2 coefficient gamma2 = xi^((2(p-1))/3)
_FROB6_C1 = XI.pow((P - 1) // 3)
_FROB6_C2 = XI.pow(2 * (P - 1) // 3)
# Fp12: c1 coefficient = xi^((p-1)/6)
_FROB12_C1 = XI.pow((P - 1) // 6)


class Fp6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fp2, c1: Fp2, c2: Fp2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fp6":
        return Fp6(Fp2.zero(), Fp2.zero(), Fp2.zero())

    @staticmethod
    def one() -> "Fp6":
        return Fp6(Fp2.one(), Fp2.zero(), Fp2.zero())

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Fp6)
            and self.c0 == other.c0
            and self.c1 == other.c1
            and self.c2 == other.c2
        )

    def __add__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fp6") -> "Fp6":
        return Fp6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fp6":
        return Fp6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fp6") -> "Fp6":
        # Toom/Karatsuba-lite interpolation over v^3 = xi
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0, t1, t2 = a0 * b0, a1 * b1, a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2.mul_by_nonresidue()
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fp6(c0, c1, c2)

    def mul_fp2(self, k: Fp2) -> "Fp6":
        return Fp6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_1(self, b1: Fp2) -> "Fp6":
        """Sparse product with (0, b1, 0) (fp6.rs:113-123): 3 Fp2 muls."""
        return Fp6(
            (self.c2 * b1).mul_by_nonresidue(), self.c0 * b1, self.c1 * b1
        )

    def mul_by_01(self, b0: Fp2, b1: Fp2) -> "Fp6":
        """Sparse product with (b0, b1, 0) (fp6.rs:125-137): 5 Fp2 muls."""
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = ((a1 + a2) * b1 - t1).mul_by_nonresidue() + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        c2 = (a0 + a2) * b0 - t0 + t1
        return Fp6(c0, c1, c2)

    def square(self) -> "Fp6":
        # Chung-Hasan SQR2: 3 Fp2 squarings + 2 Fp2 muls (vs 6 muls dense)
        a0, a1, a2 = self.c0, self.c1, self.c2
        s0 = a0.square()
        ab = a0 * a1
        s1 = ab + ab
        s2 = (a0 - a1 + a2).square()
        bc = a1 * a2
        s3 = bc + bc
        s4 = a2.square()
        return Fp6(
            s3.mul_by_nonresidue() + s0,
            s4.mul_by_nonresidue() + s1,
            s1 + s2 + s3 - s0 - s4,
        )

    def mul_by_nonresidue(self) -> "Fp6":
        """Multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1) (fp6.rs:139-151)."""
        return Fp6(self.c2.mul_by_nonresidue(), self.c0, self.c1)

    def frobenius(self) -> "Fp6":
        return Fp6(
            self.c0.frobenius(),
            self.c1.frobenius() * _FROB6_C1,
            self.c2.frobenius() * _FROB6_C2,
        )

    def inv(self) -> "Fp6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0.square() - (a1 * a2).mul_by_nonresidue()
        t1 = a2.square().mul_by_nonresidue() - a0 * a1
        t2 = a1.square() - a0 * a2
        norm = a0 * t0 + (a2 * t1).mul_by_nonresidue() + (a1 * t2).mul_by_nonresidue()
        # norm is in Fp2 with zero u-part? No — norm is a genuine Fp2 element.
        ninv = norm.inv()
        return Fp6(t0 * ninv, t1 * ninv, t2 * ninv)


class Fp12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fp6, c1: Fp6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fp12":
        return Fp12(Fp6.one(), Fp6.zero())

    def is_one(self) -> bool:
        return self == Fp12.one()

    def __eq__(self, other) -> bool:
        return isinstance(other, Fp12) and self.c0 == other.c0 and self.c1 == other.c1

    def __mul__(self, o: "Fp12") -> "Fp12":
        a0, a1, b0, b1 = self.c0, self.c1, o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        return Fp12(
            t0 + t1.mul_by_nonresidue(),
            (a0 + a1) * (b0 + b1) - t0 - t1,
        )

    def square(self) -> "Fp12":
        # Karatsuba squaring: 2 Fp6 muls (vs 3 for a dense multiply);
        # (a0 + a1 w)^2 with w^2 = v.
        a0, a1 = self.c0, self.c1
        t = a0 * a1
        c0 = (a0 + a1) * (a0 + a1.mul_by_nonresidue()) - t - t.mul_by_nonresidue()
        return Fp12(c0, t + t)

    def cyclotomic_square(self) -> "Fp12":
        """Granger-Scott squaring for elements of the cyclotomic subgroup
        (f^(p^6+1) = 1, i.e. anything after the easy part of the final
        exponentiation): 3 Fp4 squarings = 9 Fp2 squarings, ~2x faster
        than a generic square (counterpart of fp12.rs cyclotomic path via
        pairings.rs final_exponentiation)."""

        def fp4_square(a: Fp2, b: Fp2):
            # (a + b t)^2 in Fp4 = Fp2[t]/(t^2 - xi)
            t0 = a.square()
            t1 = b.square()
            return t1.mul_by_nonresidue() + t0, (a + b).square() - t0 - t1

        # coefficients of f = sum z_i w'^i in the Fp2[w']/(w'^6 - xi) view
        z0, z4, z3 = self.c0.c0, self.c0.c1, self.c0.c2
        z2, z1, z5 = self.c1.c0, self.c1.c1, self.c1.c2

        t0, t1 = fp4_square(z0, z1)
        z0 = (t0 - z0) + (t0 - z0) + t0
        z1 = (t1 + z1) + (t1 + z1) + t1
        t0, t1 = fp4_square(z2, z3)
        t2, t3 = fp4_square(z4, z5)
        z4 = (t0 - z4) + (t0 - z4) + t0
        z5 = (t1 + z5) + (t1 + z5) + t1
        t3x = t3.mul_by_nonresidue()
        z2 = (t3x + z2) + (t3x + z2) + t3x
        z3 = (t2 - z3) + (t2 - z3) + t2
        return Fp12(Fp6(z0, z4, z3), Fp6(z2, z1, z5))

    def mul_by_014(self, a: Fp2, b: Fp2, c: Fp2) -> "Fp12":
        """Sparse product with Fp12(Fp6(a, b, 0), Fp6(0, c, 0)) — the shape
        of a Miller-loop line element (fp12.rs:116-129). ~13 Fp2 muls vs 18
        for a dense multiply."""
        t0 = self.c0.mul_by_01(a, b)
        t1 = self.c1.mul_by_1(c)
        return Fp12(
            t0 + t1.mul_by_nonresidue(),
            (self.c0 + self.c1).mul_by_01(a, b + c) - t0 - t1,
        )

    def conjugate(self) -> "Fp12":
        """The Fp12 conjugation = exponentiation by p^6 (fp12.rs:136-143)."""
        return Fp12(self.c0, -self.c1)

    def frobenius(self) -> "Fp12":
        c0 = self.c0.frobenius()
        c1 = self.c1.frobenius()
        c1 = Fp6(c1.c0 * _FROB12_C1, c1.c1 * _FROB12_C1, c1.c2 * _FROB12_C1)
        return Fp12(c0, c1)

    def inv(self) -> "Fp12":
        norm = self.c0.square() - self.c1.square().mul_by_nonresidue()
        ninv = norm.inv()
        return Fp12(self.c0 * ninv, -(self.c1 * ninv))

    def pow(self, e: int) -> "Fp12":
        if e < 0:
            return self.inv().pow(-e)
        result, base = Fp12.one(), self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result
