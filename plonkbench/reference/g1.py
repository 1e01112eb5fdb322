"""BLS12-381 G1 on Python integers (Jacobian coordinates, identity Z = 0).

Frozen copy of ``baby_plonk_tpu_torch/curves/g1.py`` and the parts of
``baby_plonk_tpu_torch/fields/fq.py`` it uses, at commit 7bdee1a: the group
law, scalar multiplication by width-4 wNAF, the 48-byte compressed encoding
and its decoding with the subgroup check. Left out: the uncompressed form,
batch normalization and hashing.
"""
from __future__ import annotations

from .fr import Q as FR_ORDER

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
B = 4
GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
BLS_X_ABS = 0xD201000000010000
_BLS_X_BITS = bin(BLS_X_ABS)[2:]
#: nontrivial cube root of unity in Fq: (x, y) -> (BETA x, y) is [-x^2] on the r-torsion
BETA = pow(2, (P - 1) // 3, P)


def _sqrt(a: int) -> int | None:
    """a^((p+1)/4), valid since p = 3 mod 4; None for a non-residue."""
    r = pow(a, (P + 1) >> 2, P)
    return r if r * r % P == a % P else None


class G1:
    __slots__ = ("x", "y", "z")

    def __init__(self, x: int, y: int, z: int):
        self.x, self.y, self.z = x % P, y % P, z % P

    @staticmethod
    def identity() -> "G1":
        return G1(1, 1, 0)

    @staticmethod
    def generator() -> "G1":
        return G1(GEN_X, GEN_Y, 1)

    def to_affine(self) -> tuple[int, int] | None:
        if self.z == 0:
            return None
        zinv = pow(self.z, P - 2, P)
        zinv2 = zinv * zinv % P
        return (self.x * zinv2 % P, self.y * zinv2 % P * zinv % P)

    def double(self) -> "G1":
        if self.z == 0:
            return self
        X, Y, Z = self.x, self.y, self.z
        A = X * X % P
        Bq = Y * Y % P
        C = Bq * Bq % P
        D = 2 * ((X + Bq) * (X + Bq) - A - C) % P
        E = 3 * A % P
        F = E * E % P
        X3 = (F - 2 * D) % P
        Y3 = (E * (D - X3) - 8 * C) % P
        Z3 = 2 * Y * Z % P
        return G1(X3, Y3, Z3)

    def __add__(self, o: "G1") -> "G1":
        if self.z == 0:
            return o
        if o.z == 0:
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = o.x, o.y, o.z
        Z1Z1 = Z1 * Z1 % P
        Z2Z2 = Z2 * Z2 % P
        U1 = X1 * Z2Z2 % P
        U2 = X2 * Z1Z1 % P
        S1 = Y1 * Z2 % P * Z2Z2 % P
        S2 = Y2 * Z1 % P * Z1Z1 % P
        if U1 == U2:
            if S1 == S2:
                return self.double()
            return G1.identity()
        H = (U2 - U1) % P
        I = 4 * H * H % P
        J = H * I % P
        r = 2 * (S2 - S1) % P
        V = U1 * I % P
        X3 = (r * r - J - 2 * V) % P
        Y3 = (r * (V - X3) - 2 * S1 * J) % P
        Z3 = 2 * H * Z1 % P * Z2 % P
        return G1(X3, Y3, Z3)

    def __neg__(self) -> "G1":
        return G1(self.x, -self.y, self.z)

    def __sub__(self, o: "G1") -> "G1":
        return self + (-o)

    def _mul_int(self, k: int) -> "G1":
        """[k]P for k >= 0, not reduced mod r (the subgroup check needs that)."""
        if k == 0 or self.z == 0:
            return G1.identity()
        digits = []
        while k:
            if k & 1:
                d = k & 15
                if d > 8:
                    d -= 16
                k -= d
            else:
                d = 0
            digits.append(d)
            k >>= 1
        dbl = self.double()
        odd = [self]
        for _ in range(3):
            odd.append(odd[-1] + dbl)
        result = G1.identity()
        for d in reversed(digits):
            result = result.double()
            if d > 0:
                result = result + odd[d >> 1]
            elif d < 0:
                result = result - odd[(-d) >> 1]
        return result

    def __mul__(self, k: int) -> "G1":
        return self._mul_int(int(k) % FR_ORDER)

    __rmul__ = __mul__

    def _mul_abs_x(self) -> "G1":
        result = G1.identity()
        for bit in _BLS_X_BITS:
            result = result.double()
            if bit == "1":
                result = result + self
        return result

    def __eq__(self, other) -> bool:
        if not isinstance(other, G1):
            return NotImplemented
        if self.z == 0 or other.z == 0:
            return self.z == 0 and other.z == 0
        Z1Z1 = self.z * self.z % P
        Z2Z2 = other.z * other.z % P
        if self.x * Z2Z2 % P != other.x * Z1Z1 % P:
            return False
        return self.y * Z2Z2 % P * other.z % P == other.y * Z1Z1 % P * self.z % P

    def is_torsion_free(self) -> bool:
        """phi(P) == [-x^2] P, the r-torsion test of the compressed decoding."""
        endo = G1(self.x * BETA, self.y, self.z)
        return endo == -(self._mul_abs_x()._mul_abs_x())

    def to_compressed(self) -> bytes:
        """48-byte big-endian x, flags 0x80 (compressed), 0x40 (identity), 0x20 (y's sign)."""
        if self.z == 0:
            return bytes([0xC0]) + bytes(47)
        x, y = self.to_affine()
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80
        if y > (P - 1) // 2:
            out[0] |= 0x20
        return bytes(out)

    @staticmethod
    def from_compressed(data: bytes) -> "G1 | None":
        if len(data) != 48 or not data[0] & 0x80:
            return None
        infinity, sort = bool(data[0] & 0x40), bool(data[0] & 0x20)
        body = bytes([data[0] & 0x1F]) + data[1:]
        if infinity:
            return None if sort or any(body) else G1.identity()
        x = int.from_bytes(body, "big")
        if x >= P:
            return None
        y = _sqrt((x * x % P * x + B) % P)
        if y is None:
            return None
        if (y > (P - 1) // 2) != sort:
            y = (-y) % P
        pt = G1(x, y, 1)
        return pt if pt.is_torsion_free() else None
