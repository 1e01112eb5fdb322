"""BLS12-381 G1 group — host-side exact arithmetic (Jacobian coordinates).

Curve: y^2 = x^3 + 4 over Fp. Reference parity: lib/bls12_381/src/g1.rs
(group law g1.rs:638-752, serialization g1.rs:221-391). Implemented from
the curve equations with Jacobian coordinates — NOT a port of the
reference's homogeneous complete formulas; the device kernels in
``baby_plonk_tpu_torch.ops.g1_vec`` use branchless complete formulas instead.

Points are ``G1`` objects; the identity is represented by Z == 0.
Serialization matches zkcrypto's 48-byte compressed / 96-byte uncompressed
encodings bit-for-bit (validated against the upstream golden vectors).
"""
from __future__ import annotations

from ..fields import fq

P = fq.P
B = 4

# Standard generator (g1.rs:615, RFC 9380 / zkcrypto constants).
GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# Fr group order (cofactor-cleared subgroup order).
from ..fields.fr import Q as FR_ORDER  # noqa: E402

#: |x| for the BLS parameter x = -0xd201000000010000 (lib/bls12_381/src/lib.rs:72-74)
BLS_X_ABS = 0xD201000000010000
_BLS_X_BITS = bin(BLS_X_ABS)[2:]

#: nontrivial cube root of unity in Fq: the endomorphism (x, y) -> (BETA*x, y)
#: acts as multiplication by -x^2 on the r-torsion (derived as 2^((p-1)/3)
#: and selected by checking phi(G) == -[x^2]G; same role as g1.rs:421-428).
BETA = pow(2, (P - 1) // 3, P)


class G1:
    """Jacobian point (X, Y, Z): affine x = X/Z^2, y = Y/Z^3; identity has Z = 0."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: int, y: int, z: int):
        self.x, self.y, self.z = x % P, y % P, z % P

    @staticmethod
    def identity() -> "G1":
        return G1(1, 1, 0)

    @staticmethod
    def generator() -> "G1":
        return G1(GEN_X, GEN_Y, 1)

    @staticmethod
    def from_affine(x: int, y: int) -> "G1":
        return G1(x, y, 1)

    def is_identity(self) -> bool:
        return self.z == 0

    def to_affine(self) -> tuple[int, int] | None:
        """Returns (x, y) or None for the identity."""
        if self.z == 0:
            return None
        zinv = fq.inv(self.z)
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
        """[k]P for a nonnegative integer k WITHOUT reduction mod r —
        required for subgroup checks, where the point may not lie in the
        r-torsion and [r]P != identity. Width-4 wNAF (255 doubles + ~51
        adds instead of ~127; cf. the reference's plain double-and-add,
        g1.rs:755-775 — constant-time there, variable-time is fine host-side)."""
        assert k >= 0
        if k == 0 or self.z == 0:
            return G1.identity()
        # wNAF digits, window 4: odd digits in [-7, 7]
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
        # odd multiples 1P, 3P, 5P, 7P
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
        """[|x|]P — few set bits in the BLS parameter, so plain double-and-add."""
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
        # X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3
        Z1Z1 = self.z * self.z % P
        Z2Z2 = other.z * other.z % P
        if self.x * Z2Z2 % P != other.x * Z1Z1 % P:
            return False
        return self.y * Z2Z2 % P * other.z % P == other.y * Z1Z1 % P * self.z % P

    def __hash__(self):
        aff = self.to_affine()
        return hash(aff)

    def is_on_curve(self) -> bool:
        if self.z == 0:
            return True
        x, y = self.to_affine()
        return y * y % P == (x * x % P * x + B) % P

    @staticmethod
    def batch_normalize(points: list["G1"]) -> list[tuple[int, int] | None]:
        """Affine coordinates for a batch with ONE field inversion
        (Montgomery's trick; public counterpart of g1.rs:806-839).
        Identity entries map to None. The device-array variant is
        ``ops.g1_vec.batch_normalize``."""
        zs = [p.z for p in points if p.z != 0]
        if not zs:
            return [None] * len(points)
        # prefix products and a single inversion
        prefix = [1]
        for z in zs:
            prefix.append(prefix[-1] * z % P)
        inv_total = fq.inv(prefix[-1])
        zinvs = [0] * len(zs)
        for i in range(len(zs) - 1, -1, -1):
            zinvs[i] = prefix[i] * inv_total % P
            inv_total = inv_total * zs[i] % P
        out: list[tuple[int, int] | None] = []
        j = 0
        for p in points:
            if p.z == 0:
                out.append(None)
            else:
                zi = zinvs[j]
                j += 1
                zi2 = zi * zi % P
                out.append((p.x * zi2 % P, p.y * zi2 % P * zi % P))
        return out

    def endomorphism(self) -> "G1":
        """phi(x, y) = (BETA*x, y); in Jacobian just scale X (affine x = X/Z^2)."""
        return G1(self.x * BETA % P, self.y, self.z)

    def is_torsion_free(self) -> bool:
        """Subgroup membership via the GLV endomorphism: P is in the
        r-torsion iff phi(P) == -[x^2]P (eprint 2021/1130 §6; the
        reference uses the same check, g1.rs:401-410). ~128 doublings
        instead of a full 255-bit scalar multiplication — and unlike a
        naive ``self * FR_ORDER`` it cannot be silently defeated by
        scalar reduction mod r."""
        if self.is_identity():
            return True
        return self.endomorphism() == -(self._mul_abs_x()._mul_abs_x())

    # -- serialization (g1.rs:221-391 format) --------------------------------

    def to_compressed(self) -> bytes:
        """48-byte big-endian x with flag bits 0x80 (compressed), 0x40 (inf), 0x20 (y sign)."""
        if self.z == 0:
            out = bytearray(48)
            out[0] = 0xC0
            return bytes(out)
        x, y = self.to_affine()
        out = bytearray(fq.to_bytes_be(x))
        out[0] |= 0x80
        if fq.lexicographically_largest(y):
            out[0] |= 0x20
        return bytes(out)

    def to_uncompressed(self) -> bytes:
        if self.z == 0:
            out = bytearray(96)
            out[0] = 0x40
            return bytes(out)
        x, y = self.to_affine()
        return fq.to_bytes_be(x) + fq.to_bytes_be(y)

    @staticmethod
    def from_compressed(data: bytes) -> "G1 | None":
        if len(data) != 48:
            return None
        flags = data[0]
        compression = bool(flags & 0x80)
        infinity = bool(flags & 0x40)
        sort = bool(flags & 0x20)
        if not compression:
            return None
        body = bytes([data[0] & 0x1F]) + data[1:]
        if infinity:
            if sort or any(body):
                return None
            return G1.identity()
        x = fq.from_bytes_be(body)
        if x is None:
            return None
        y = fq.sqrt((x * x % P * x + B) % P)
        if y is None:
            return None
        if fq.lexicographically_largest(y) != sort:
            y = (-y) % P
        pt = G1.from_affine(x, y)
        if not pt.is_torsion_free():
            return None
        return pt

    @staticmethod
    def from_uncompressed(data: bytes) -> "G1 | None":
        if len(data) != 96:
            return None
        flags = data[0]
        if flags & 0x80 or flags & 0x20:
            return None
        infinity = bool(flags & 0x40)
        body = bytes([data[0] & 0x1F]) + data[1:]
        if infinity:
            if any(body):
                return None
            return G1.identity()
        x = fq.from_bytes_be(body[:48])
        y = fq.from_bytes_be(body[48:])
        if x is None or y is None:
            return None
        pt = G1.from_affine(x, y)
        if not pt.is_on_curve() or not pt.is_torsion_free():
            return None
        return pt

    def __repr__(self):
        aff = self.to_affine()
        if aff is None:
            return "G1(identity)"
        return f"G1({hex(aff[0])}, {hex(aff[1])})"
