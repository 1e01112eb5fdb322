"""BLS12-381 scalar field Fr on Python integers.

Frozen copy of ``baby_plonk_tpu_torch/fields/fr.py`` at commit 7bdee1a
(the modulus, the roots of unity, inversion and the canonical 32-byte
encoding; the rest left out). A later change to the port's field code
cannot move the yardstick.
"""
from __future__ import annotations

Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
GENERATOR = 7
TWO_ADICITY = 32
ROOT_OF_UNITY = pow(GENERATOR, (Q - 1) >> TWO_ADICITY, Q)


def inv(a: int) -> int:
    if a % Q == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, Q - 2, Q)


def root_of_unity(group_order: int) -> int:
    """Primitive group_order-th root of unity: ROOT_OF_UNITY^(2^32 / n)."""
    if group_order & (group_order - 1) or not 1 <= group_order <= 1 << TWO_ADICITY:
        raise ValueError(f"group order {group_order}: expected a power of two up to 2^32")
    return pow(ROOT_OF_UNITY, (1 << TWO_ADICITY) // group_order, Q)


def roots_of_unity(group_order: int) -> list[int]:
    """[1, w, w^2, ..., w^(n-1)]."""
    w = root_of_unity(group_order)
    out = [1] * group_order
    for i in range(1, group_order):
        out[i] = out[i - 1] * w % Q
    return out


def to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian encoding."""
    return int(a % Q).to_bytes(32, "little")


def from_bytes(b: bytes) -> int | None:
    """Canonical decode; None for a non-canonical encoding."""
    v = int.from_bytes(b, "little")
    return v if v < Q else None
