"""Keccak-f[1600] permutation — host-side, used by the STROBE-128 transcript.

Standard FIPS-202 permutation (24 rounds) over a 200-byte state with
little-endian 64-bit lanes, lane (x, y) at byte offset 8*(x + 5*y).
"""
from __future__ import annotations

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets indexed by (x + 5*y)
_ROTATIONS = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state (native when available)."""
    assert len(state) == 200
    try:
        from .. import native

        if native.available():
            native.keccak_f1600(state)
            return
    except Exception:
        pass
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]

    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for y in range(5):
            for x in range(5):
                lanes[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for y in range(5):
            for x in range(5):
                # B[y, 2x+3y] = rot(A[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(lanes[x + 5 * y], _ROTATIONS[x + 5 * y])
        # chi
        for y in range(5):
            row = b[5 * y : 5 * y + 5]
            for x in range(5):
                lanes[x + 5 * y] = row[x] ^ ((~row[(x + 1) % 5] & _MASK) & row[(x + 2) % 5])
        # iota
        lanes[0] ^= rc

    for i in range(25):
        state[8 * i : 8 * i + 8] = lanes[i].to_bytes(8, "little")
