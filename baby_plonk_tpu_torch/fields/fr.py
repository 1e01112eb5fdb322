"""BLS12-381 scalar field Fr (a.k.a. Fq in some texts) — host-side exact arithmetic.

This is the prime field of order

    q = 0x73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001

used for circuit values, polynomial coefficients, and NTT domains.

Reference parity: lib/bls12_381/src/scalar.rs:83-89 (modulus),
scalar.rs:106-113 (generator = 7), scalar.rs:199 (2-adicity S = 32),
scalar.rs:208-213 (ROOT_OF_UNITY = 7^((q-1)/2^32)).

Host-side we use Python integers (arbitrary precision, exact); the device
limb-vector kernels (``baby_plonk_tpu_torch.ops.limbs`` with the Fr FieldSpec,
used by ``ops.ntt`` / ``ops.dpoly``) are validated against this module
limb-for-limb.
"""
from __future__ import annotations

# Field modulus (255-bit prime).
Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

#: Multiplicative generator of Fr^* (quadratic non-residue).
GENERATOR = 7

#: 2-adicity: q - 1 = 2^32 * t with t odd.
TWO_ADICITY = 32

#: Generator of the order-2^32 multiplicative subgroup.
ROOT_OF_UNITY = pow(GENERATOR, (Q - 1) >> TWO_ADICITY, Q)
ROOT_OF_UNITY_INV = pow(ROOT_OF_UNITY, Q - 2, Q)

BYTES = 32


def add(a: int, b: int) -> int:
    return (a + b) % Q


def sub(a: int, b: int) -> int:
    return (a - b) % Q


def mul(a: int, b: int) -> int:
    return (a * b) % Q


def neg(a: int) -> int:
    return (-a) % Q


def inv(a: int) -> int:
    if a % Q == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, Q - 2, Q)


def batch_inv(values):
    """Montgomery batch inversion: one field inversion + 3(n-1) muls.

    Counterpart of the reference's per-element addchain
    inversions (prover.rs:304-315 performs 3n serial ``invert()`` calls;
    we never do that).
    """
    values = list(values)
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % Q
    total_inv = inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * total_inv % Q
        total_inv = total_inv * values[i] % Q
    return out


def root_of_unity(group_order: int) -> int:
    """Primitive group_order-th root of unity.

    Matches utils.rs:39-43: ROOT_OF_UNITY^(2^32 / group_order).
    """
    assert group_order & (group_order - 1) == 0, "group order must be a power of two"
    assert group_order <= (1 << TWO_ADICITY)
    return pow(ROOT_OF_UNITY, (1 << TWO_ADICITY) // group_order, Q)


def roots_of_unity(group_order: int) -> list[int]:
    """[1, w, w^2, ..., w^(n-1)] — matches utils.rs:45-52."""
    w = root_of_unity(group_order)
    out = [1]
    for _ in range(group_order - 1):
        out.append(out[-1] * w % Q)
    return out


def pow_vartime(a: int, e: int) -> int:
    """a^e — variable-time exponentiation (scalar.rs:397-414). Host ints
    are not constant-time anyway; provided for library API parity."""
    return pow(a % Q, e, Q)


def sqrt(a: int) -> int | None:
    """Square root via Tonelli–Shanks over the 2-adic subgroup
    (scalar.rs:381-395 uses the same structure: q - 1 = 2^32 * t).

    Returns a root r with r^2 = a (mod q), or None if a is a non-residue.
    """
    a = a % Q
    if a == 0:
        return 0
    t_odd = (Q - 1) >> TWO_ADICITY
    # initial guess x = a^((t+1)/2); b = a^t
    x = pow(a, (t_odd + 1) // 2, Q)
    b = pow(a, t_odd, Q)
    g = pow(GENERATOR, t_odd, Q)  # order-2^32 generator (= ROOT_OF_UNITY)
    r = TWO_ADICITY
    while b != 1:
        # find least m with b^(2^m) = 1
        m = 0
        t = b
        while t != 1:
            t = t * t % Q
            m += 1
            if m == r:
                return None  # non-residue
        gs = pow(g, 1 << (r - m - 1), Q)
        x = x * gs % Q
        g = gs * gs % Q
        b = b * g % Q
        r = m
    return x


def from_bytes_wide(b: bytes) -> int:
    """64-byte little-endian uniform reduction mod q (scalar.rs:308-338).

    The reference computes d0 + d1*R via Montgomery R2/R3 constants; the
    result is the canonical residue of the 512-bit integer, which exact
    host arithmetic produces directly.
    """
    assert len(b) == 64
    return int.from_bytes(b, "little") % Q


def to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian encoding (scalar.rs:292-306)."""
    return int(a % Q).to_bytes(32, "little")


def from_bytes(b: bytes) -> int | None:
    """Canonical decode; returns None for non-canonical input (scalar.rs:264-290)."""
    assert len(b) == 32
    v = int.from_bytes(b, "little")
    if v >= Q:
        return None
    return v
