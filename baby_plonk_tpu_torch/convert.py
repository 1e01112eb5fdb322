"""Carry state between the JAX package and the port.

Neither package imports the other, and their types are distinct (the
port's ``G1``, ``Poly``, ``Setup`` are its own classes), so state crosses
at canonical values only: Python ints, affine coordinate pairs, bytes and
numpy limb arrays.

Limb arrays: the JAX package keeps limbs as uint32 (tables optionally
uint16) numpy / jax arrays; the port keeps the same limb-major layouts as
int32 tensors:

  * device SRS (px, py, pz): (24, n) x3
  * fixed-base tables (tx, ty): (24, G, 256) x2
  * Fr value arrays: (16, ..., n)

Protocol objects: an SRS as affine (x, y) int pairs or as its limb arrays,
with ``x_2`` as 96 compressed bytes or six int coordinates
(x.c0, x.c1, y.c0, y.c1, z.c0, z.c1) -> the port's ``Setup``; a proof's
624 bytes -> the port's ``Proof``; a program's constraint strings and group
order -> the port's ``Program``.
"""
from __future__ import annotations

import numpy as np
import torch


def to_torch(a, device="cpu") -> torch.Tensor:
    """uint16 / uint32 limb array -> int32 tensor (same layout)."""
    a = np.asarray(a)
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError("limb values must be 16-bit")
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (the JAX package's dtype)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def srs_to_torch(points, device="cpu"):
    return tuple(to_torch(c, device) for c in points)


def srs_to_numpy(points):
    return tuple(to_numpy(c) for c in points)


def tables_to_torch(tables, device="cpu"):
    return tuple(to_torch(c, device) for c in tables)


def tables_to_numpy(tables):
    return tuple(to_numpy(c) for c in tables)


# -- protocol objects -----------------------------------------------------------


def g2_from(x2):
    """The port's G2 from 96 compressed bytes or six int coordinates
    (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1)."""
    from .curves.g2 import G2
    from .fields.tower import Fp2

    if isinstance(x2, (bytes, bytearray)):
        pt = G2.from_compressed(bytes(x2))
        if pt is None:
            raise ValueError("x_2: not a compressed G2 point")
        return pt
    c = [int(v) for v in x2]
    if len(c) != 6:
        raise ValueError("x_2: expected 96 bytes or six int coordinates")
    return G2(Fp2(c[0], c[1]), Fp2(c[2], c[3]), Fp2(c[4], c[5]))


def g2_coords(pt) -> tuple:
    """Six int coordinates of a G2 point of either package."""
    return (pt.x.c0, pt.x.c1, pt.y.c0, pt.y.c1, pt.z.c0, pt.z.c1)


def setup_from_affine(points, x2):
    """SRS given as affine (x, y) int pairs (None = identity) -> the port's
    host ``Setup``."""
    from .curves.g1 import G1
    from .protocol.setup import Setup

    pts = [G1.identity() if p is None else G1.from_affine(int(p[0]), int(p[1])) for p in points]
    return Setup(pts, g2_from(x2))


def setup_to_affine(setup) -> list:
    """The port's ``Setup`` -> affine (x, y) int pairs (None = identity)."""
    from .curves.g1 import G1

    setup.materialize_host()
    return G1.batch_normalize(list(setup.powers_of_x))


def setup_from_limbs(points, x2, device="cpu"):
    """SRS given as its (24, n) x3 Montgomery projective limb arrays -> the
    port's ``Setup`` with the points on ``device`` (no host point list)."""
    from .protocol.setup import Setup

    pts = srs_to_torch(points, device)
    if len(pts) != 3 or any(c.shape != pts[0].shape or c.shape[0] != 24 for c in pts):
        raise ValueError("SRS limb arrays must be three (24, n) arrays")
    setup = Setup(None, g2_from(x2), n_powers=pts[0].shape[-1])
    setup.device_points[str(torch.device(device))] = pts
    return setup


def setup_to_limbs(setup, device="cpu"):
    """The port's ``Setup`` -> (24, n) x3 uint32 limb arrays."""
    from .ops import srs

    return srs_to_numpy(srs.setup_points(setup, torch.device(device)))


def proof_from_bytes(data: bytes):
    """A proof's 624 bytes -> the port's ``Proof``."""
    from .protocol.proof import Proof

    return Proof.from_bytes(bytes(data))


def program_from_strs(constraints, group_order: int):
    """Constraint strings and group order -> the port's ``Program``."""
    from .protocol.program import Program

    return Program.from_strs([str(c) for c in constraints], int(group_order))
