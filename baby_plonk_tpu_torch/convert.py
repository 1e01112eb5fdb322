"""Carry state between the JAX package and the port.

The JAX package keeps limbs as uint32 (tables optionally uint16) numpy /
jax arrays; the port keeps the same limb-major layouts as int32 tensors.
These helpers take and return numpy arrays, so neither package imports the
other's framework:

  * device SRS (px, py, pz): (24, n) x3
  * fixed-base tables (tx, ty): (24, G, 256) x2
  * Fr value arrays: (16, ..., n)
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
