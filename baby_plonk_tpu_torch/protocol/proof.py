"""PLONK proof object + wire format.

Matches the reference Proof struct (verifier.rs:24-40): 9 G1 points and
6 Fr scalars. The reference has no serialization at all (SURVEY.md §5);
we define the natural wire format: 9 x 48-byte compressed G1 followed by
6 x 32-byte little-endian scalars = 624 bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

from ..curves.g1 import G1
from ..fields import fr

_POINTS = ("a_1", "b_1", "c_1", "z_1", "t_lo_1", "t_mid_1", "t_hi_1", "w_zeta_1", "w_zeta_omega_1")
_SCALARS = ("a_bar", "b_bar", "c_bar", "s1_bar", "s2_bar", "z_omega_bar")

SERIALIZED_LEN = 9 * 48 + 6 * 32


@dataclass
class Proof:
    a_1: G1
    b_1: G1
    c_1: G1
    z_1: G1
    t_lo_1: G1
    t_mid_1: G1
    t_hi_1: G1
    w_zeta_1: G1
    w_zeta_omega_1: G1
    a_bar: int
    b_bar: int
    c_bar: int
    s1_bar: int
    s2_bar: int
    z_omega_bar: int

    def to_bytes(self) -> bytes:
        out = bytearray()
        for name in _POINTS:
            out += getattr(self, name).to_compressed()
        for name in _SCALARS:
            out += fr.to_bytes(getattr(self, name))
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        assert len(data) == SERIALIZED_LEN, f"proof must be {SERIALIZED_LEN} bytes"
        kwargs = {}
        off = 0
        for name in _POINTS:
            pt = G1.from_compressed(data[off : off + 48])
            if pt is None:
                raise ValueError(f"invalid G1 encoding for {name}")
            kwargs[name] = pt
            off += 48
        for name in _SCALARS:
            s = fr.from_bytes(data[off : off + 32])
            if s is None:
                raise ValueError(f"non-canonical scalar for {name}")
            kwargs[name] = s
            off += 32
        return Proof(**kwargs)

    def __eq__(self, other):
        if not isinstance(other, Proof):
            return NotImplemented
        return all(getattr(self, f.name) == getattr(other, f.name) for f in fields(self))
