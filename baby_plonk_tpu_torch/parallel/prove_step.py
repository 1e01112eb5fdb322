"""The prover's round-1 compute over the mesh (counterpart of
``baby_plonk_tpu/parallel/prove_step.py``): the sharded inverse NTT of
the three witness columns, then three sharded commits. The SRS is taken in
cyclic order, the order the distributed transform emits, so coefficient j
and power tau^j lie on the same shard and nothing is permuted between the
NTT and the MSMs.
"""
from __future__ import annotations

from ..ops import limbs
from ..ops.limbs import FR
from . import dmsm, dntt
from .dntt import cyclic_perm  # noqa: F401  (the layout's permutation, under the JAX package's name)


def prove_step_sharded(cols, px, py, pz, mesh):
    """``cols``: (16, 3, n) Montgomery witness columns a | b | c (Lagrange
    values, natural order); ``px``, ``py``, ``pz``: (24, n) SRS powers in
    cyclic order (position k1 m + k2 holds tau^(k2 D + k1)). Returns the
    three commitments, (24,) x3 each on ``home``: the bit-serial MSM a
    shard, as the JAX package's step."""
    dntt.check_shape(cols.shape[-1], mesh.D)
    coeffs = dntt._local_fourstep(mesh.shard(cols), mesh, inverse=True)  # cyclic coefficients
    raw = [limbs.from_mont(FR, c) for c in coeffs]
    points = list(zip(*(mesh.shard(c) for c in (px, py, pz))))
    return tuple(dmsm.msm_sharded_arrays(points, [r[:, i] for r in raw], mesh) for i in range(3))
