"""Gt — the pairing target group as a first-class type.

Reference parity: lib/bls12_381/src/pairings.rs:211-296 (Gt group ops:
neg/add/sub/double/scalar-mul, identity/generator) and the
``pairing::Engine`` surface (pairings.rs:793-823). The group is the
order-r subgroup of Fp12* reached by ``final_exponentiation``; group
notation is ADDITIVE here (matching the reference's `Group` impl), so
``+`` is an Fp12 multiply, ``-`` is conjugation (the cyclotomic inverse:
every Gt element satisfies z^(p^6+1) = 1, so z^-1 = z^(p^6) = conj(z)),
and ``double`` uses the Granger–Scott cyclotomic squaring.

Serialization is 576 bytes: the 12 Fq coefficients big-endian, order
c0.c0.c0, c0.c0.c1, c0.c1.c0, ... c1.c2.c1 (tower-lexicographic — the
reference exposes no Gt wire format, so this one is ours and
``from_bytes`` subgroup-checks by r-order).
"""
from __future__ import annotations

from ..fields import fq, fr
from ..fields.tower import Fp2, Fp6, Fp12

__all__ = ["Gt"]


def _fp12_coeffs(f: Fp12) -> list[int]:
    out = []
    for c6 in (f.c0, f.c1):
        for c2 in (c6.c0, c6.c1, c6.c2):
            out.extend((c2.c0, c2.c1))
    return out


def _fp12_from_coeffs(cs: list[int]) -> Fp12:
    sext = [Fp2(cs[2 * i], cs[2 * i + 1]) for i in range(6)]
    return Fp12(Fp6(*sext[:3]), Fp6(*sext[3:]))


class Gt:
    """Target-group element (additive notation over a multiplicative
    Fp12 subgroup, like the reference's ``Gt``)."""

    __slots__ = ("f",)

    def __init__(self, f: Fp12):
        self.f = f

    @staticmethod
    def identity() -> "Gt":
        return Gt(Fp12.one())

    @staticmethod
    def generator() -> "Gt":
        """e(G1_gen, G2_gen) — cached (pairings.rs:248-292 stores the
        precomputed constant; we compute it once per process)."""
        global _GEN
        if _GEN is None:
            from .g1 import G1
            from .g2 import G2
            from .pairing import pairing

            _GEN = Gt(pairing(G1.generator(), G2.generator()))
        return Gt(_GEN.f)

    def is_identity(self) -> bool:
        return self.f.is_one()

    def double(self) -> "Gt":
        return Gt(self.f.cyclotomic_square())

    def __neg__(self) -> "Gt":
        return Gt(self.f.conjugate())

    def __add__(self, o: "Gt") -> "Gt":
        return Gt(self.f * o.f)

    def __sub__(self, o: "Gt") -> "Gt":
        return Gt(self.f * o.f.conjugate())

    def __mul__(self, k: int) -> "Gt":
        """Scalar multiple [k]g = g^k (mod r), double-and-add over the
        cyclotomic square / Fp12 multiply."""
        k = int(k) % fr.Q
        acc = Gt.identity()
        base = self
        while k:
            if k & 1:
                acc = acc + base
            base = base.double()
            k >>= 1
        return acc

    __rmul__ = __mul__

    def __eq__(self, other) -> bool:
        return isinstance(other, Gt) and self.f == other.f

    def __hash__(self):
        return hash(tuple(_fp12_coeffs(self.f)))

    def is_torsion_free(self) -> bool:
        """r-order check: g^r == 1 (every final_exponentiation output
        lands in the r-torsion of the cyclotomic subgroup)."""
        return self.f.pow(fr.Q).is_one()

    def to_bytes(self) -> bytes:
        return b"".join(c.to_bytes(48, "big") for c in _fp12_coeffs(self.f))

    @staticmethod
    def from_bytes(data: bytes) -> "Gt | None":
        if len(data) != 576:
            return None
        cs = [int.from_bytes(data[48 * i : 48 * (i + 1)], "big") for i in range(12)]
        if any(c >= fq.P for c in cs):
            return None
        g = Gt(_fp12_from_coeffs(cs))
        if not g.f.pow(fr.Q).is_one():
            return None  # not in the r-order target subgroup
        return g

    def __repr__(self):
        return f"Gt({'identity' if self.is_identity() else self.to_bytes()[:8].hex() + '...'})"


_GEN: Gt | None = None
