"""Fiat-Shamir transcript: byte-exact replication of merlin 3.0 (STROBE-128).

The reference drives its transcript through the ``merlin`` crate
(src/transcript.rs:65-86); for proofs to cross-verify between the stacks
our challenge derivation must match merlin byte-for-byte. This module
reimplements:

  * STROBE-128 over Keccak-f[1600] (rate R = 166, security 128), with the
    ``meta_ad`` / ``ad`` / ``prf`` operations merlin uses;
  * merlin's ``Transcript`` framing: protocol label ``b"Merlin v1.0"``,
    ``dom-sep`` domain separation, u32-LE length-prefixed appends;
  * the reference's PLONK round schedule (src/transcript.rs:8-62),
    including the quirks that MUST be preserved:
      - the alpha challenge label is ``b"z_1"``, not ``b"alpha"``
        (transcript.rs:24);
      - challenge bytes are rejection-sampled until they decode to a
        canonical non-zero scalar, and the accepted bytes are re-appended
        to the transcript (transcript.rs:70-82);
      - points are absorbed as 48-byte compressed G1 (transcript.rs:66-69),
        scalars as 32-byte little-endian (transcript.rs:83-85).

Validated against merlin's published test vector
("test protocol"/"some data" -> d5a21972...).
"""
from __future__ import annotations

from ..fields import fr
from ..utils.keccak import keccak_f1600

STROBE_R = 166

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    """STROBE-128 duplex construction, the subset merlin needs."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

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
            assert self.cur_flags == flags, "cannot continue a different op"
            return
        assert flags & _FLAG_T == 0, "transport flags not implemented (merlin never uses T)"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
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


class MerlinTranscript:
    """merlin 3.0 Transcript framing over Strobe128."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)


class PlonkTranscript:
    """The reference's 5-round PLONK transcript schedule (src/transcript.rs:4-63).

    Points are passed as objects exposing ``to_compressed() -> bytes``
    (48-byte G1); scalars as canonical Fr ints.
    """

    def __init__(self, domain: bytes = b"plonk"):
        self.t = MerlinTranscript(domain)

    def append_point(self, label: bytes, point) -> None:
        self.t.append_message(label, point.to_compressed())

    def append_scalar(self, label: bytes, scalar: int) -> None:
        self.t.append_message(label, fr.to_bytes(scalar))

    def get_and_append_challenge(self, label: bytes) -> int:
        """Rejection-sample a canonical nonzero Fr scalar (transcript.rs:70-82)."""
        while True:
            raw = self.t.challenge_bytes(label, 32)
            s = fr.from_bytes(raw)
            if s is not None and s != 0:
                self.t.append_message(label, raw)
                return s

    # -- round schedule (labels are part of the wire format) -----------------

    def round_1(self, a_1, b_1, c_1) -> tuple[int, int]:
        self.append_point(b"a_1", a_1)
        self.append_point(b"b_1", b_1)
        self.append_point(b"c_1", c_1)
        beta = self.get_and_append_challenge(b"beta")
        gamma = self.get_and_append_challenge(b"gamma")
        return beta, gamma

    def round_2(self, z_1) -> int:
        self.append_point(b"z_1", z_1)
        # Quirk preserved from transcript.rs:24: alpha is squeezed under the
        # label b"z_1" (not b"alpha").
        return self.get_and_append_challenge(b"z_1")

    def round_3(self, t_lo_1, t_mid_1, t_hi_1) -> int:
        self.append_point(b"t_lo_1", t_lo_1)
        self.append_point(b"t_mid_1", t_mid_1)
        self.append_point(b"t_hi_1", t_hi_1)
        return self.get_and_append_challenge(b"zeta")

    def round_4(self, a_bar, b_bar, c_bar, s1_bar, s2_bar, z_omega_bar) -> int:
        self.append_scalar(b"a_eval", a_bar)
        self.append_scalar(b"b_eval", b_bar)
        self.append_scalar(b"c_eval", c_bar)
        self.append_scalar(b"s1_eval", s1_bar)
        self.append_scalar(b"s2_eval", s2_bar)
        self.append_scalar(b"z_shifted_eval", z_omega_bar)
        return self.get_and_append_challenge(b"nu")

    def round_5(self, w_zeta_1, w_zeta_omega_1) -> int:
        self.append_point(b"w_zeta_1", w_zeta_1)
        self.append_point(b"w_zeta_omega_1", w_zeta_omega_1)
        return self.get_and_append_challenge(b"mu")
