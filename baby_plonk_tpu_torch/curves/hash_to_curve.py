"""RFC 9380 hash-to-curve for BLS12-381: XMD/XOF expanders, hash_to_field,
simplified-SWU maps with 11-/3-isogenies, and cofactor clearing.

Capability parity with the reference's feature-gated `hash_to_curve` module
(lib/bls12_381/src/hash_to_curve/{mod,expand_msg,map_g1,map_g2,map_scalar}.rs):
the same four suites BLS12381G{1,2}_XMD:SHA-256_SSWU_{RO,NU}_, the same
expand_message_xmd/xof primitives, and hash-to-scalar.  Host-side by design —
hashing one message is latency-bound scalar work (two field elements, one
sqrt, one cofactor mul), not a device-shaped workload; the device path begins
where bulk polynomial/MSM work does.  Variable-time Python stands in for the
reference's constant-time subtle machinery (same stance as curves/g1.py).

Validated against the draft-12 vectors the reference embeds (identical to the
published RFC 9380 appendix K/J vectors): see tests/test_torch_hash_to_curve.py.
A copy of ``baby_plonk_tpu/curves/hash_to_curve.py`` whose relative imports
resolve to the port's own fields and curves.
"""
from __future__ import annotations

import hashlib

from ..fields import fq, fr
from ..fields.tower import Fp2
from . import h2c_data as D
from .g1 import G1
from .g2 import G2

P = fq.P

# ---------------------------------------------------------------------------
# expand_message (RFC 9380 5.4; expand_msg.rs:100-296)
# ---------------------------------------------------------------------------

_OVERSIZE_PREFIX = b"H2C-OVERSIZE-DST-"


def _xmd_dst_prime(dst: bytes, hash_name: str) -> bytes:
    if len(dst) > 255:
        dst = hashlib.new(hash_name, _OVERSIZE_PREFIX + dst).digest()
    return dst + bytes([len(dst)])


def expand_message_xmd(
    msg: bytes, dst: bytes, len_in_bytes: int, hash_name: str = "sha256"
) -> bytes:
    """expand_message_xmd (RFC 9380 5.4.1; expand_msg.rs:178-296)."""
    h = hashlib.new(hash_name)
    b_in_bytes = h.digest_size
    s_in_bytes = h.block_size
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535:
        raise ValueError("requested output too long for expand_message_xmd")
    dst_prime = _xmd_dst_prime(dst, hash_name)
    z_pad = b"\x00" * s_in_bytes
    l_i_b = len_in_bytes.to_bytes(2, "big")
    b0 = hashlib.new(hash_name, z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bi = hashlib.new(hash_name, b0 + b"\x01" + dst_prime).digest()
    out = [bi]
    for i in range(2, ell + 1):
        xored = bytes(a ^ b for a, b in zip(b0, bi))
        bi = hashlib.new(hash_name, xored + bytes([i]) + dst_prime).digest()
        out.append(bi)
    return b"".join(out)[:len_in_bytes]


def expand_message_xof(
    msg: bytes, dst: bytes, len_in_bytes: int, xof_name: str = "shake_128"
) -> bytes:
    """expand_message_xof (RFC 9380 5.4.2; expand_msg.rs:120-176)."""
    if len(dst) > 255:
        # replacement DST is ceil(2k/8) bytes of the XOF (RFC 9380 5.3.3):
        # 32 for shake_128 (k = 128), 64 for shake_256 (k = 256)
        k_bytes = {"shake_128": 32, "shake_256": 64}[xof_name]
        x = hashlib.new(xof_name)
        x.update(_OVERSIZE_PREFIX + dst)
        dst = x.digest(k_bytes)
    dst_prime = dst + bytes([len(dst)])
    x = hashlib.new(xof_name)
    x.update(msg + len_in_bytes.to_bytes(2, "big") + dst_prime)
    return x.digest(len_in_bytes)


# ---------------------------------------------------------------------------
# hash_to_field (RFC 9380 5.3; mod.rs:27-57, map_scalar.rs:7-17)
# ---------------------------------------------------------------------------


def _hash_to_field_ints(msg, dst, count, m, length, modulus, expand):
    okm = expand(msg, dst, count * m * length)
    vals = []
    for i in range(count):
        elem = []
        for j in range(m):
            off = (i * m + j) * length
            elem.append(int.from_bytes(okm[off : off + length], "big") % modulus)
        vals.append(elem)
    return vals


def hash_to_field_fq(msg, dst, count, expand=expand_message_xmd):
    """count Fq elements; L = 64 (map_g1.rs:505-527)."""
    return [v[0] for v in _hash_to_field_ints(msg, dst, count, 1, 64, P, expand)]


def hash_to_field_fq2(msg, dst, count, expand=expand_message_xmd):
    """count Fp2 elements; L = 64 per component (map_g2.rs:369-377)."""
    return [
        Fp2(v[0], v[1]) for v in _hash_to_field_ints(msg, dst, count, 2, 64, P, expand)
    ]


def hash_to_fr(msg, dst, count=1, expand=expand_message_xmd):
    """count scalar-field elements; L = 48 (map_scalar.rs:7-17)."""
    return [v[0] for v in _hash_to_field_ints(msg, dst, count, 1, 48, fr.Q, expand)]


# ---------------------------------------------------------------------------
# simplified SWU (RFC 9380 6.6.2 + F.2; map_g1.rs:544-580, map_g2.rs:388-452)
# ---------------------------------------------------------------------------


class _FqOps:
    """Fp arithmetic adapter so one SSWU routine serves both G1 and G2."""

    A, B, Z = D.SSWU_A1, D.SSWU_B1, D.SSWU_Z1

    add = staticmethod(lambda a, b: (a + b) % P)
    mul = staticmethod(lambda a, b: a * b % P)
    sq = staticmethod(lambda a: a * a % P)
    neg = staticmethod(lambda a: -a % P)
    is_zero = staticmethod(lambda a: a == 0)
    inv0 = staticmethod(lambda a: 0 if a == 0 else fq.inv(a))
    sqrt = staticmethod(fq.sqrt)  # None when non-square

    @staticmethod
    def sgn0(a):
        return a & 1


_FqOps.C1 = _FqOps.mul(_FqOps.neg(_FqOps.B), _FqOps.inv0(_FqOps.A))  # -B/A


class _Fq2Ops:
    A = Fp2(*D.SSWU_A2)
    B = Fp2(*D.SSWU_B2)
    Z = Fp2(*D.SSWU_Z2)

    add = staticmethod(lambda a, b: a + b)
    mul = staticmethod(lambda a, b: a * b)
    sq = staticmethod(lambda a: a.square())
    neg = staticmethod(lambda a: -a)
    is_zero = staticmethod(lambda a: a.is_zero())
    inv0 = staticmethod(lambda a: Fp2.zero() if a.is_zero() else a.inv())
    sqrt = staticmethod(lambda a: a.sqrt())

    @staticmethod
    def sgn0(a):
        # sign of c0, falling through to c1 when c0 == 0 (RFC 4.1)
        return (a.c0 & 1) if a.c0 != 0 else (a.c1 & 1)


_Fq2Ops.C1 = -_Fq2Ops.B * _Fq2Ops.A.inv()  # -B/A

#: 3-isogeny coefficient lists lifted to Fp2 once (not per map call)
_ISO3_FP2 = tuple(
    [Fp2(a, b) for a, b in coeffs]
    for coeffs in (D.ISO3_XNUM, D.ISO3_XDEN, D.ISO3_YNUM, D.ISO3_YDEN)
)


def _sswu(F, u):
    """(x, y) on the isogenous curve E': y^2 = x^3 + A x + B (RFC F.2)."""
    tv1 = F.mul(F.Z, F.sq(u))  # Z u^2
    tv2 = F.sq(tv1)  # Z^2 u^4
    s = F.add(tv1, tv2)
    c1 = F.C1  # -B / A, precomputed per curve
    if F.is_zero(s):
        x1 = F.mul(c1, F.neg(F.inv0(F.Z)))  # B / (Z A)
    else:
        x1 = F.mul(c1, F.add(F.inv0(s), _one(F)))
    gx1 = F.add(F.mul(F.add(F.sq(x1), F.A), x1), F.B)
    y = F.sqrt(gx1)
    if y is not None:
        x = x1
    else:
        x = F.mul(tv1, x1)  # Z u^2 x1
        gx2 = F.mul(gx1, F.mul(tv1, tv2))  # gx1 * Z^3 u^6
        y = F.sqrt(gx2)
        assert y is not None, "SSWU: gx2 must be square when gx1 is not"
    if F.sgn0(u) != F.sgn0(y):
        y = F.neg(y)
    return x, y


def _one(F):
    return 1 if F is _FqOps else Fp2.one()


def _iso_map(F, x, y, xnum, xden, ynum, yden):
    """Evaluate the isogeny E' -> E at an affine point by Horner
    (map_g1.rs:583-627; coefficient lists ascending, leading terms explicit)."""

    def horner(coeffs):
        acc = coeffs[-1]
        for c in reversed(coeffs[:-1]):
            acc = F.add(F.mul(acc, x), c)
        return acc

    xd = horner(xden)
    yd = horner(yden)
    if F.is_zero(xd) or F.is_zero(yd):
        return None  # exceptional point maps to infinity
    nx = F.mul(horner(xnum), F.inv0(xd))
    ny = F.mul(y, F.mul(horner(ynum), F.inv0(yd)))
    return nx, ny


def map_to_curve_g1(u: int) -> G1:
    """Fq element -> point on E1 (NOT yet in the subgroup); map_g1.rs:629-632."""
    x, y = _sswu(_FqOps, u % P)
    aff = _iso_map(
        _FqOps, x, y, D.ISO11_XNUM, D.ISO11_XDEN, D.ISO11_YNUM, D.ISO11_YDEN
    )
    if aff is None:
        return G1.identity()
    return G1.from_affine(*aff)


def map_to_curve_g2(u: Fp2) -> G2:
    """Fp2 element -> point on E2 (NOT yet in the subgroup); map_g2.rs:494-497."""
    x, y = _sswu(_Fq2Ops, u)
    aff = _iso_map(_Fq2Ops, x, y, *_ISO3_FP2)
    if aff is None:
        return G2.identity()
    return G2.from_affine(*aff)


# ---------------------------------------------------------------------------
# cofactor clearing (RFC 9380 7; map_g1.rs:634-637, map_g2.rs:499-502)
# ---------------------------------------------------------------------------

#: G1 effective cofactor 1 - x (x the BLS parameter; RFC 8.8.1)
H_EFF_G1 = 0xD201000000010001

#: G2 effective cofactor (RFC 8.8.2); the psi-based clearing below equals
#: multiplication by this on all of E2(Fp2) — asserted in tests
H_EFF_G2 = int(
    "bc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff031508ffe1329c2f1787"
    "31db956d82bf015d1212b02ec0ec69d7477c1ae954cbc06689f6a359894c0adebbf6b4e80"
    "20005aaa95551",
    16,
)


def clear_cofactor_g1(p: G1) -> G1:
    return p._mul_int(H_EFF_G1)


def clear_cofactor_g2(p: G2) -> G2:
    """Budroni–Pintore psi-based clearing:
    psi^2(2P) + [x^2 - x - 1]P + [x - 1]psi(P), with [x]Q = -[|x|]Q
    (x negative).  O(2 short scalar muls) vs the 636-bit H_EFF_G2 ladder."""
    t1 = -p._mul_abs_x()  # [x] P
    t2 = p.psi()
    return p.double().psi().psi() + (-(t1 + t2)._mul_abs_x()) - t1 - t2 - p


# ---------------------------------------------------------------------------
# suites (RFC 9380 8.8; mod.rs:71-100)
# ---------------------------------------------------------------------------


def hash_to_g1(msg: bytes, dst: bytes, expand=expand_message_xmd) -> G1:
    """BLS12381G1_XMD:SHA-256_SSWU_RO_ (random-oracle encoding)."""
    u0, u1 = hash_to_field_fq(msg, dst, 2, expand)
    return clear_cofactor_g1(map_to_curve_g1(u0) + map_to_curve_g1(u1))


def encode_to_g1(msg: bytes, dst: bytes, expand=expand_message_xmd) -> G1:
    """BLS12381G1_XMD:SHA-256_SSWU_NU_ (non-uniform encoding)."""
    (u,) = hash_to_field_fq(msg, dst, 1, expand)
    return clear_cofactor_g1(map_to_curve_g1(u))


def hash_to_g2(msg: bytes, dst: bytes, expand=expand_message_xmd) -> G2:
    """BLS12381G2_XMD:SHA-256_SSWU_RO_."""
    u0, u1 = hash_to_field_fq2(msg, dst, 2, expand)
    return clear_cofactor_g2(map_to_curve_g2(u0) + map_to_curve_g2(u1))


def encode_to_g2(msg: bytes, dst: bytes, expand=expand_message_xmd) -> G2:
    """BLS12381G2_XMD:SHA-256_SSWU_NU_."""
    (u,) = hash_to_field_fq2(msg, dst, 1, expand)
    return clear_cofactor_g2(map_to_curve_g2(u))
