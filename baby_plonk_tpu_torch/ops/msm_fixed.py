"""Fixed-base MSM for KZG commits: per-SRS subset-sum tables and the
Horner loop over them (counterpart of ``baby_plonk_tpu/ops/msm_fixed.py``).

Points are grouped 8 at a time; for each group the 256 subset sums
T[g][idx] = sum_{j in idx} P_{8g+j} are built once per SRS and stored
affine, (24, G, 256) int32 x2, with the identity as the (0, 0) marker.
A commit then runs, per group lane, 255 MSB-first Horner steps
acc = 2 acc + T[g][bits of the group's 8 scalars] over 2^14-point chunks,
tree-reduces the per-lane partials within each chunk and combines the
chunks (``msm._combine_partials``, baby_plonk_tpu/ops/msm.py:101-116).

Kernels (csrc/msm_fixed.cu): ``build_tables`` (build + normalization,
counterpart of ``_build_tables``, ops/msm_fixed.py:82-131) and
``msm_fixed_horner`` (counterpart of ``msm_fixed_pallas``,
ops/pallas_kernels.py:242, and its XLA twin ``_msm_fixed_kernel_oh``,
ops/msm_fixed.py:197-228). Each sits beside its plain version.
"""
from __future__ import annotations

import torch

from . import g1_vec, kernels, srs

GROUP = 8
NB = 1 << GROUP
#: points per chunk (the JAX package's CHUNK)
CHUNK = 1 << 14
#: Horner steps: bit 254 down to 0 (bit 255 of a canonical Fr scalar is 0)
NBITS = 255


# -- table build ----------------------------------------------------------------


def build_tables_plain(px, py, pz):
    """(24, 8G) x3 projective Montgomery -> (tx, ty) (24, G, 256) affine,
    int64. Level b appends entries [2^b, 2^(b+1)) = T[idx - 2^b] + P_b."""
    G = px.shape[-1] // GROUP
    pts = tuple(c.to(torch.int64).reshape(24, G, GROUP) for c in (px, py, pz))
    T = g1_vec.pidentity((G, 1), px.device, torch.int64)
    for b in range(GROUP):
        width = 1 << b
        pb = tuple(c[:, :, b : b + 1].expand(24, G, width) for c in pts)
        new = g1_vec.padd_plain(T, pb)
        T = tuple(torch.cat([t, n], dim=-1) for t, n in zip(T, new))
    return g1_vec.batch_normalize(T, plain=True)


def build_tables(px, py, pz):
    """Subset-sum tables of the 8-point groups of (24, 8G) x3 points."""
    if kernels.on_cpu(px, py, pz):
        return tuple(t.to(torch.int32) for t in build_tables_plain(px, py, pz))
    dev = kernels.check_cuda(px, py, pz)
    n = px.shape[-1]
    if px.shape[0] != 24 or n % GROUP or any(c.shape != px.shape for c in (py, pz)):
        raise ValueError(f"build_tables: bad point shape {tuple(px.shape)}")
    G = n // GROUP
    px, py, pz = (c.contiguous() for c in (px, py, pz))
    tx, ty, tz = (torch.empty((24, G, NB), dtype=torch.int32, device=dev) for _ in range(3))
    s = kernels.stream(dev)
    kernels.launch("bpt_msm_build_tables", *(kernels.ptr(c) for c in (px, py, pz)), G,
                   kernels.ptr(tx), kernels.ptr(ty), kernels.ptr(tz), s)
    kernels.launch("bpt_msm_normalize_tables", kernels.ptr(tx), kernels.ptr(ty), kernels.ptr(tz), G, s)
    build_tables.launches += 1
    return tx, ty


build_tables.launches = 0


# -- Horner loop ----------------------------------------------------------------


def _table_index(scalars, bit: int):
    """(16, P, 8G) raw limbs -> (P, G) 8-bit table index of ``bit``."""
    P, W = scalars.shape[1], scalars.shape[2]
    b = (scalars[bit >> 4].reshape(P, W // GROUP, GROUP) >> (bit & 15)) & 1
    shifts = torch.arange(GROUP, device=scalars.device)
    return (b << shifts).sum(-1)


def msm_fixed_plain(tx, ty, scalars):
    """Plain Horner loop: tables (24, Gt, 256), scalars (16, P, 8G) raw,
    G <= Gt -> per-lane projective partials (24, P, G), int64."""
    P, G = scalars.shape[1], scalars.shape[2] // GROUP
    tx, ty = tx[:, :G].to(torch.int64), ty[:, :G].to(torch.int64)
    sc = scalars.to(torch.int64)
    lanes = torch.arange(G, device=tx.device)[None, :]
    acc = g1_vec.pidentity((P, G), tx.device, torch.int64)
    for bit in range(NBITS - 1, -1, -1):
        idx = _table_index(sc, bit)
        qx, qy = tx[:, lanes, idx], ty[:, lanes, idx]  # (24, P, G)
        acc = g1_vec.pdouble_plain(acc)
        added = g1_vec.padd_mixed_plain(acc, qx, qy)
        marker = (qx == 0).all(0) & (qy == 0).all(0)  # (0, 0) = identity
        acc = g1_vec.pselect(marker, acc, added)
    return acc


def msm_fixed_horner(tx, ty, scalars):
    """Per-lane Horner partials (24, P, G) of P scalar sets (16, P, 8G)
    against the first G groups of the tables."""
    if kernels.on_cpu(tx, ty, scalars):
        return tuple(c.to(torch.int32) for c in msm_fixed_plain(tx, ty, scalars))
    dev = kernels.check_cuda(tx, ty, scalars)
    Gt = tx.shape[1]
    P, W = scalars.shape[1], scalars.shape[2]
    G = W // GROUP
    if tx.shape != (24, Gt, NB) or ty.shape != tx.shape or scalars.shape[0] != 16 or W % GROUP or G > Gt:
        raise ValueError("msm_fixed_horner: bad table or scalar shape")
    tx, ty, scalars = tx.contiguous(), ty.contiguous(), scalars.contiguous()
    out = tuple(torch.empty((24, P, G), dtype=torch.int32, device=dev) for _ in range(3))
    if P * G:
        kernels.launch("bpt_msm_fixed", kernels.ptr(tx), kernels.ptr(ty), Gt, kernels.ptr(scalars),
                       P, G, *(kernels.ptr(c) for c in out), kernels.stream(dev))
        msm_fixed_horner.launches += 1
    return out


msm_fixed_horner.launches = 0


# -- per-SRS tables -------------------------------------------------------------


class FixedBaseTables:
    """Subset-sum tables over a fixed point set (24, n) x3, in chunks of
    ``chunk`` points (a ragged last chunk is padded with copies of its first
    point; padded lanes only ever see zero scalar bits). All chunks are
    built at the first MSM."""

    def __init__(self, points, chunk: int = CHUNK):
        self.points = points
        self.n = points[0].shape[-1]
        assert chunk % GROUP == 0 and (chunk // GROUP) & (chunk // GROUP - 1) == 0
        self.chunk = chunk
        self.nchunks = -(-self.n // chunk)
        self._tables = None

    def tables(self):
        if self._tables is None:
            parts = []
            for ci in range(self.nchunks):
                lo, hi = ci * self.chunk, min((ci + 1) * self.chunk, self.n)
                pad = self.chunk - (hi - lo)
                parts.append(tuple(
                    torch.cat([c[:, lo:hi], c[:, lo : lo + 1].expand(24, pad)], dim=-1)
                    for c in self.points
                ))
            pts = tuple(torch.cat([p[i] for p in parts], dim=-1) for i in range(3))
            self._tables = build_tables(*pts)
        return self._tables

    def msm_many(self, scalars_list):
        """MSMs of several raw scalar arrays (16, k_i), k_i <= n, against the
        first k_i points. Returns (X, Y, Z) of shape (24, P)."""
        P = len(scalars_list)
        k = max(s.shape[-1] for s in scalars_list)
        assert k <= self.n, (k, self.n)
        nch = max(-(-k // self.chunk), 1)
        dev = self.points[0].device
        sc = torch.zeros((16, P, nch * self.chunk), dtype=torch.int32, device=dev)
        for i, s in enumerate(scalars_list):
            sc[:, i, : s.shape[-1]] = s
        tx, ty = self.tables()
        part = msm_fixed_horner(tx, ty, sc)  # (24, P, nch * Gc)
        Gc = self.chunk // GROUP
        per_chunk = g1_vec.tree_reduce(tuple(c.reshape(24, P, nch, Gc) for c in part))
        return g1_vec.combine_partials(per_chunk)

    def msm(self, scalars):
        return tuple(c[:, 0] for c in self.msm_many([scalars]))


def tables_for_setup(setup, device) -> FixedBaseTables:
    """Per-setup, per-device cached tables over the SRS (chunk = the next
    power of two >= min(n, CHUNK), as ``msm_fixed.tables_for_setup``)."""
    cache = setup.fb_tables
    key = str(device)
    tabs = cache.get(key)
    if tabs is None:
        pts = srs.setup_points(setup, device)
        n = pts[0].shape[-1]
        c = GROUP
        while c < min(n, CHUNK):
            c <<= 1
        tabs = cache[key] = FixedBaseTables(pts, chunk=c)
    return tabs
