"""BLS12-381 base field Fp (381-bit) — host-side exact arithmetic.

Reference parity: lib/bls12_381/src/fp.rs:70-78 (modulus). Host side uses
Python integers; the device limb kernels in ``baby_plonk_tpu_torch.ops.limbs``
are validated against this module.
"""
from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

BYTES = 48


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def neg(a: int) -> int:
    return (-a) % P


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in Fp")
    return pow(a, P - 2, P)


def sqrt(a: int) -> int | None:
    """Square root via a^((p+1)/4), valid since p ≡ 3 (mod 4) (fp.rs:324-340)."""
    r = pow(a, (P + 1) >> 2, P)
    if r * r % P != a % P:
        return None
    return r


def lexicographically_largest(a: int) -> bool:
    """True iff a > (p-1)/2 — the compressed-point sign convention (fp.rs:273-300)."""
    return a > (P - 1) // 2


def to_bytes_be(a: int) -> bytes:
    return int(a % P).to_bytes(48, "big")


def from_bytes_be(b: bytes) -> int | None:
    assert len(b) == 48
    v = int.from_bytes(b, "big")
    if v >= P:
        return None
    return v
