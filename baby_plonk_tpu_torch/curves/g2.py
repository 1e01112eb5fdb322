"""BLS12-381 G2 group — host-side exact arithmetic (Jacobian over Fp2).

Twist curve: y^2 = x^3 + 4(u+1) over Fp2. Reference parity:
lib/bls12_381/src/g2.rs (group law g2.rs:709-844, serialization
g2.rs:254-466). The verifier only needs x_2 = tau*G2 and the generator
(no G2 MSM exists in the reference), so this stays host-side.
"""
from __future__ import annotations

from ..fields import fq
from ..fields.fr import Q as FR_ORDER
from ..fields.tower import Fp2, XI

B2 = Fp2(4, 4)  # 4(u + 1)

#: |x| for the BLS parameter x = -0xd201000000010000 (lib/bls12_381/src/lib.rs:72-74)
BLS_X_ABS = 0xD201000000010000
_BLS_X_BITS = bin(BLS_X_ABS)[2:]

#: psi = untwist-Frobenius-twist endomorphism constants:
#: psi(x, y) = (C_X * conj(x), C_Y * conj(y)), acting as multiplication by
#: p == x (mod r) on the r-torsion (derived from xi = u+1 and validated by
#: psi(G) == [p mod r]G; same role as g2.rs:847-913).
PSI_C_X = XI.pow((fq.P - 1) // 3).inv()
PSI_C_Y = XI.pow((fq.P - 1) // 2).inv()

GEN_X = Fp2(
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
GEN_Y = Fp2(
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)


class G2:
    """Jacobian point over Fp2; identity has Z = 0."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: Fp2, y: Fp2, z: Fp2):
        self.x, self.y, self.z = x, y, z

    @staticmethod
    def identity() -> "G2":
        return G2(Fp2.one(), Fp2.one(), Fp2.zero())

    @staticmethod
    def generator() -> "G2":
        return G2(GEN_X, GEN_Y, Fp2.one())

    @staticmethod
    def from_affine(x: Fp2, y: Fp2) -> "G2":
        return G2(x, y, Fp2.one())

    def is_identity(self) -> bool:
        return self.z.is_zero()

    def to_affine(self) -> tuple[Fp2, Fp2] | None:
        if self.z.is_zero():
            return None
        zinv = self.z.inv()
        zinv2 = zinv.square()
        return (self.x * zinv2, self.y * zinv2 * zinv)

    def double(self) -> "G2":
        if self.z.is_zero():
            return self
        X, Y, Z = self.x, self.y, self.z
        A = X.square()
        Bf = Y.square()
        C = Bf.square()
        D = ((X + Bf).square() - A - C)
        D = D + D
        E = A + A + A
        F = E.square()
        X3 = F - (D + D)
        Y3 = E * (D - X3) - C.mul_fp(8)
        Z3 = (Y * Z)
        Z3 = Z3 + Z3
        return G2(X3, Y3, Z3)

    def __add__(self, o: "G2") -> "G2":
        if self.z.is_zero():
            return o
        if o.z.is_zero():
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        X2, Y2, Z2 = o.x, o.y, o.z
        Z1Z1 = Z1.square()
        Z2Z2 = Z2.square()
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        if U1 == U2:
            if S1 == S2:
                return self.double()
            return G2.identity()
        H = U2 - U1
        I = (H + H).square()
        J = H * I
        r = S2 - S1
        r = r + r
        V = U1 * I
        X3 = r.square() - J - (V + V)
        S1J = S1 * J
        Y3 = r * (V - X3) - (S1J + S1J)
        Z3 = ((Z1 * Z2) * H)
        Z3 = Z3 + Z3
        return G2(X3, Y3, Z3)

    def __neg__(self) -> "G2":
        return G2(self.x, -self.y, self.z)

    def __sub__(self, o: "G2") -> "G2":
        return self + (-o)

    def _mul_int(self, k: int) -> "G2":
        """[k]P for a nonnegative integer WITHOUT reduction mod r (see
        G1._mul_int — needed for subgroup checks)."""
        assert k >= 0
        result = G2.identity()
        base = self
        while k:
            if k & 1:
                result = result + base
            base = base.double()
            k >>= 1
        return result

    def __mul__(self, k: int) -> "G2":
        return self._mul_int(int(k) % FR_ORDER)

    __rmul__ = __mul__

    def _mul_abs_x(self) -> "G2":
        """[|x|]P — few set bits in the BLS parameter."""
        result = G2.identity()
        for bit in _BLS_X_BITS:
            result = result.double()
            if bit == "1":
                result = result + self
        return result

    def psi(self) -> "G2":
        """Untwist-Frobenius-twist endomorphism; field conjugation commutes
        with the Jacobian quotient, so apply coordinate-wise with the
        affine constants folded in (x = X/Z^2 -> C_X conj(X) / conj(Z)^2
        needs X scaled by C_X only when Z is conjugated too)."""
        return G2(
            PSI_C_X * self.x.conjugate(),
            PSI_C_Y * self.y.conjugate(),
            self.z.conjugate(),
        )

    def __eq__(self, other) -> bool:
        if not isinstance(other, G2):
            return NotImplemented
        if self.z.is_zero() or other.z.is_zero():
            return self.z.is_zero() and other.z.is_zero()
        Z1Z1 = self.z.square()
        Z2Z2 = other.z.square()
        if self.x * Z2Z2 != other.x * Z1Z1:
            return False
        return self.y * Z2Z2 * other.z == other.y * Z1Z1 * self.z

    def is_on_curve(self) -> bool:
        if self.z.is_zero():
            return True
        x, y = self.to_affine()
        return y.square() == x.square() * x + B2

    # -- serialization (g2.rs:254-466 format) --------------------------------

    def to_compressed(self) -> bytes:
        """96 bytes: x.c1 then x.c0, big-endian, flags on first byte."""
        if self.z.is_zero():
            out = bytearray(96)
            out[0] = 0xC0
            return bytes(out)
        x, y = self.to_affine()
        out = bytearray(fq.to_bytes_be(x.c1) + fq.to_bytes_be(x.c0))
        out[0] |= 0x80
        if y.lexicographically_largest():
            out[0] |= 0x20
        return bytes(out)

    def to_uncompressed(self) -> bytes:
        if self.z.is_zero():
            out = bytearray(192)
            out[0] = 0x40
            return bytes(out)
        x, y = self.to_affine()
        return (
            fq.to_bytes_be(x.c1)
            + fq.to_bytes_be(x.c0)
            + fq.to_bytes_be(y.c1)
            + fq.to_bytes_be(y.c0)
        )

    @staticmethod
    def from_compressed(data: bytes) -> "G2 | None":
        if len(data) != 96:
            return None
        flags = data[0]
        if not flags & 0x80:
            return None
        infinity = bool(flags & 0x40)
        sort = bool(flags & 0x20)
        body = bytes([data[0] & 0x1F]) + data[1:]
        if infinity:
            if sort or any(body):
                return None
            return G2.identity()
        xc1 = fq.from_bytes_be(body[:48])
        xc0 = fq.from_bytes_be(body[48:])
        if xc1 is None or xc0 is None:
            return None
        x = Fp2(xc0, xc1)
        y = (x.square() * x + B2).sqrt()
        if y is None:
            return None
        if y.lexicographically_largest() != sort:
            y = -y
        pt = G2.from_affine(x, y)
        if not pt.is_torsion_free():
            return None
        return pt

    @staticmethod
    def from_uncompressed(data: bytes) -> "G2 | None":
        if len(data) != 192:
            return None
        flags = data[0]
        if flags & 0x80 or flags & 0x20:
            return None
        infinity = bool(flags & 0x40)
        body = bytes([data[0] & 0x1F]) + data[1:]
        if infinity:
            if any(body):
                return None
            return G2.identity()
        xc1 = fq.from_bytes_be(body[:48])
        xc0 = fq.from_bytes_be(body[48:96])
        yc1 = fq.from_bytes_be(body[96:144])
        yc0 = fq.from_bytes_be(body[144:])
        if None in (xc1, xc0, yc1, yc0):
            return None
        pt = G2.from_affine(Fp2(xc0, xc1), Fp2(yc0, yc1))
        if not pt.is_on_curve() or not pt.is_torsion_free():
            return None
        return pt

    def is_torsion_free(self) -> bool:
        """Subgroup membership via psi: P is in the r-torsion iff
        psi(P) == [x]P (x negative, so -[|x|]P) — eprint 2019/814; the
        reference uses the same check (g2.rs:475-482). One 64-bit chain
        instead of a 255-bit scalar multiplication, and sound (a naive
        ``self * FR_ORDER`` reduces the scalar mod r and checks nothing)."""
        if self.is_identity():
            return True
        return self.psi() == -self._mul_abs_x()

    def __repr__(self):
        aff = self.to_affine()
        if aff is None:
            return "G2(identity)"
        return f"G2({aff[0]!r}, {aff[1]!r})"
