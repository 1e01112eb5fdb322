"""The PLONK Fiat-Shamir transcript: merlin 3.0 over STROBE-128 over
Keccak-f[1600].

Frozen copy of ``baby_plonk_tpu_torch/protocol/transcript.py`` and
``baby_plonk_tpu_torch/utils/keccak.py`` at commit 7bdee1a, with two
changes: Keccak is the pure-Python permutation only (the port's native
helper is not used), and points are absorbed as the 48 compressed bytes
that the proof carries, not as point objects.
"""
from __future__ import annotations

from . import fr

_MASK = (1 << 64) - 1
_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
_ROTATIONS = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place Keccak-f[1600] on a 200-byte state, lane (x, y) at byte 8 (x + 5 y)."""
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    for rc in _ROUND_CONSTANTS:
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for y in range(5):
            for x in range(5):
                lanes[x + 5 * y] ^= d[x]
        b = [0] * 25
        for y in range(5):
            for x in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(lanes[x + 5 * y], _ROTATIONS[x + 5 * y])
        for y in range(5):
            row = b[5 * y : 5 * y + 5]
            for x in range(5):
                lanes[x + 5 * y] = row[x] ^ ((~row[(x + 1) % 5] & _MASK) & row[(x + 2) % 5])
        lanes[0] ^= rc
    for i in range(25):
        state[8 * i : 8 * i + 8] = lanes[i].to_bytes(8, "little")


STROBE_R = 166
_FLAG_I, _FLAG_A, _FLAG_C, _FLAG_T, _FLAG_M, _FLAG_K = 1, 2, 4, 8, 16, 32


class Strobe128:
    """STROBE-128 duplex, the subset merlin uses."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state, self.pos, self.pos_begin, self.cur_flags = st, 0, 0, 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if self.cur_flags != flags:
                raise ValueError("cannot continue a different op")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (_FLAG_C | _FLAG_K) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)


class PlonkTranscript:
    """merlin's framing and the reference's five-round schedule
    (baby-plonk-rust src/transcript.rs): alpha is squeezed under the label
    b"z_1"; challenges are rejection-sampled to canonical nonzero scalars
    and their bytes appended again."""

    def __init__(self, domain: bytes = b"plonk"):
        self.strobe = Strobe128(b"Merlin v1.0")
        self._append(b"dom-sep", domain)

    def _append(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def _challenge(self, label: bytes) -> int:
        while True:
            self.strobe.meta_ad(label, False)
            self.strobe.meta_ad((32).to_bytes(4, "little"), True)
            raw = self.strobe.prf(32, False)
            s = fr.from_bytes(raw)
            if s is not None and s != 0:
                self._append(label, raw)
                return s

    def round_1(self, a_1: bytes, b_1: bytes, c_1: bytes) -> tuple[int, int]:
        self._append(b"a_1", a_1)
        self._append(b"b_1", b_1)
        self._append(b"c_1", c_1)
        return self._challenge(b"beta"), self._challenge(b"gamma")

    def round_2(self, z_1: bytes) -> int:
        self._append(b"z_1", z_1)
        return self._challenge(b"z_1")

    def round_3(self, t_lo_1: bytes, t_mid_1: bytes, t_hi_1: bytes) -> int:
        self._append(b"t_lo_1", t_lo_1)
        self._append(b"t_mid_1", t_mid_1)
        self._append(b"t_hi_1", t_hi_1)
        return self._challenge(b"zeta")

    def round_4(self, evals: list[int]) -> int:
        for label, v in zip((b"a_eval", b"b_eval", b"c_eval", b"s1_eval", b"s2_eval", b"z_shifted_eval"), evals):
            self._append(label, fr.to_bytes(v))
        return self._challenge(b"nu")
