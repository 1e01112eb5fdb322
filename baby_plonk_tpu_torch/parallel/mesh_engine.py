"""MeshEngine: the 5-round prover sharded over a device mesh (counterpart
of ``baby_plonk_tpu/parallel/mesh_engine.py``).

It drops into the unchanged ``protocol.Prover`` through the engine
contract and shards what the JAX package's mesh engine shards:

  * iNTT / NTT            -> four-step split, all_to_all (parallel/dntt.py)
  * KZG commits           -> one MSM a shard + gather and add
                             (parallel/dmsm.py; SRS padded and block-sharded)
  * grand product         -> scans a shard, totals folded (parallel/dscan.py)
  * round-3 quotient      -> sharded coset NTTs, the pointwise combination
                             in cyclic order, the dual inverse (this file)

Shapes that do not shard (small circuits) take ``TorchEngine``'s path on
``home``, as the JAX package's mesh engine takes ``TpuEngine``'s. Proofs
are byte-identical to ``TorchEngine``'s and the host oracle's: every step
moves Montgomery limbs, exactly.

Between the engine's calls the state lives on ``home``, unsharded: a
DPoly that leaves a call is gathered there, and the inherited evaluations
and linear combination run there. Each sharded call shards its operands
anew. Over a ``ProcessMesh`` every process runs the whole prover on equal
values: its own shards and, on its own ``home``, the unsharded state.

The four-step transform emits cyclic order (natural k2 D + k1 at gathered
position k1 m + k2). Round 3 keeps its pointwise step in that order (1/Z_H
and the domain points are permuted once per size, not the data) and
inverts through the dual transform, which takes the cyclic layout, so the
quotient pipeline has no global permute. z(w x) is z four positions on in
natural order: in cyclic order that is shard (d + 4) mod D, (d + 4) div D
lanes on, so each shard reads it from that shard's z row.
"""
from __future__ import annotations

import torch

from ..protocol.poly import Basis
from ..ops import srs
from ..ops.dpoly import DPoly, _debug_asserts, pad_to
from ..ops.limbs import FR, mont_mul
from ..ops.msm_fixed import GROUP
from ..ops.prover_kernels import _round3_consts, round3_combine, scalars
from ..ops.torch_engine import TorchEngine
from . import dmsm, dntt, dscan
from .mesh import make_mesh


def _mm(a, b):
    return mont_mul(FR, a, b)


class MeshEngine(TorchEngine):
    name = "mesh"

    def __init__(self, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh()
        super().__init__(self.mesh.home)
        self.D = self.mesh.D
        self._perms: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._r3_cyc: dict[int, tuple] = {}
        self._roots_sh: dict[int, list[torch.Tensor]] = {}

    # -- layout helpers ----------------------------------------------------------

    def _can_shard(self, n: int) -> bool:
        D = self.D
        return n % D == 0 and n // D >= D and (n // D) % D == 0

    def _perm_pair(self, n: int):
        """(to_cyclic, to_natural) index tensors on ``home``: gathered
        position k1 m + k2 holds natural index k2 D + k1."""
        pair = self._perms.get(n)
        if pair is None:
            nat_of_gath = torch.from_numpy(dntt.cyclic_perm(n, self.D)).to(self.device)
            pair = self._perms[n] = (nat_of_gath, torch.argsort(nat_of_gath))
        return pair

    def _roots_sharded(self, n: int):
        """{w^i} Montgomery, block-sharded, cached per n."""
        r = self._roots_sh.get(n)
        if r is None:
            r = self._roots_sh[n] = self.mesh.shard(self._roots_mont(n))
        return r

    def _dntt_natural(self, vals: torch.Tensor, inverse: bool) -> torch.Tensor:
        """Distributed transform of (16, ..., n) on ``home``, gathered and
        permuted to natural order."""
        n = vals.shape[-1]
        out = dntt._local_fourstep(self.mesh.shard(vals.reshape(16, -1, n)), self.mesh, inverse)
        return self.mesh.gather(out).index_select(-1, self._perm_pair(n)[1]).reshape(vals.shape)

    # -- NTT family --------------------------------------------------------------

    def intt(self, values):
        if self._can_shard(len(values)):
            return dntt.ntt_ints_sharded(values, self.mesh, inverse=True)
        return super().intt(values)

    def ntt(self, values):
        if self._can_shard(len(values)):
            return dntt.ntt_ints_sharded(values, self.mesh)
        return super().ntt(values)

    def intt_poly(self, p):
        p = self._dpoly(p)
        if not self._can_shard(len(p)):
            return super().intt_poly(p)
        assert p.basis == Basis.LAGRANGE
        return DPoly(self._dntt_natural(p.vals, True), Basis.MONOMIAL)

    def intt_polys(self, ps):
        ps = [self._dpoly(p) for p in ps]
        lens = {len(p) for p in ps}
        if len(lens) != 1 or not self._can_shard(next(iter(lens))):
            return super().intt_polys(ps)
        assert all(p.basis == Basis.LAGRANGE for p in ps)
        out = self._dntt_natural(torch.stack([p.vals for p in ps], dim=1), True)
        return [DPoly(out[:, i].contiguous(), Basis.MONOMIAL) for i in range(len(ps))]

    # -- KZG commit --------------------------------------------------------------

    def _mesh_srs(self, setup) -> dict:
        """The SRS padded to N = D 2^k points with copies of the generator
        (their scalars are always zero) and block-sharded; cached on the
        setup per mesh placement with the shards' fixed-base tables."""
        entry = setup.mesh_srs.get(self.mesh.key)
        if entry is None:
            pts = srs.setup_points(setup, self.device)
            n = pts[0].shape[-1]
            N = dmsm.pad_shard_count(n, self.D)
            if N > n:
                pts = tuple(torch.cat([c, c[:, :1].expand(24, N - n)], dim=-1) for c in pts)
            shards = list(zip(*(self.mesh.shard(c) for c in pts)))
            entry = setup.mesh_srs[self.mesh.key] = {"N": N, "points": shards, "tables": None}
        return entry

    def _commit_arrays(self, setup, scalars_raw):
        """The MSMs of raw scalar limbs [(16, k_i)] on ``home``, each padded
        with zeros to the padded SRS and block-sharded: the shards'
        fixed-base tables (when the config asks for them and a shard holds
        whole 8-point groups), else the bit-serial MSM a shard (Pippenger
        stays single-device). Returns (24, P) x3 on ``home``."""
        from ..config import get_config

        entry = self._mesh_srs(setup)
        N = entry["N"]
        shards = [self.mesh.shard(torch.cat([s, s.new_zeros((16, N - s.shape[-1]))], dim=-1))
                  for s in scalars_raw]
        if get_config().commit_fixed_base and (N // self.D) % GROUP == 0:
            if entry["tables"] is None:
                entry["tables"] = dmsm.build_tables_sharded(entry["points"], self.mesh)
            return dmsm.msm_fixed_sharded(entry["tables"], [list(s) for s in zip(*shards)], self.mesh)
        outs = [dmsm.msm_sharded_arrays(entry["points"], s, self.mesh) for s in shards]
        return tuple(torch.stack([o[k] for o in outs], dim=-1) for k in range(3))

    # -- grand product -----------------------------------------------------------

    def grand_product(self, a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2):
        if len(roots) % self.D == 0:
            return dscan.grand_product_sharded(a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2, self.mesh)
        return super().grand_product(a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2)

    def grand_product_poly(self, a, b, c, pk, beta, gamma, k1, k2):
        """Round 2 over the mesh: the Lagrange columns sharded, the sigma
        columns packed and sharded once per proving key and placement."""
        n = len(a)
        if n % self.D:
            return super().grand_product_poly(a, b, c, pk, beta, gamma, k1, k2)
        key = (self.mesh.key, n)
        sig = pk.sigma_lagrange.get(key)
        if sig is None:
            sig = pk.sigma_lagrange[key] = [
                self.mesh.shard(FR.pack_mont(p.values, self.device)) for p in (pk.s1, pk.s2, pk.s3)
            ]
        cols = [self.mesh.shard(self._dpoly(p).vals) for p in (a, b, c)]
        z, closing = dscan.grand_product_shards(
            *cols, *sig, self._roots_sharded(n), beta, gamma, k1, k2, self.mesh)
        return DPoly(self.mesh.gather(z), Basis.LAGRANGE), closing

    # -- round-3 quotient --------------------------------------------------------

    def _r3_cyclic_consts(self, m: int):
        """Round 3's coset tables (ops/prover_kernels.py::_round3_consts),
        block-sharded: g^j and g^-j in natural order, 1/Z_H and the coset
        domain points permuted into cyclic order."""
        c = self._r3_cyc.get(m)
        if c is None:
            zh_inv, gpow, ginvpow, dpow = _round3_consts(m, str(self.device))
            to_cyclic = self._perm_pair(m)[0]
            c = self._r3_cyc[m] = tuple(self.mesh.shard(t) for t in (
                zh_inv.index_select(-1, to_cyclic), gpow, ginvpow, dpow.index_select(-1, to_cyclic)))
        return c

    def _coset_dntt(self, polys, m: int, gpow):
        """(16, r, m/D) a shard, cyclic: the forward transforms of the
        coset-scaled polys zero-padded to m."""
        stacked = torch.stack([pad_to(p.vals, m) for p in polys], dim=1)
        shards = [_mm(x, g[:, None, :]) for x, g in zip(self.mesh.shard(stacked), gpow)]
        return dntt._local_fourstep(shards, self.mesh, inverse=False)

    def round3_quotient(self, *args, pk_cache=None):
        """The sharded ``prover_kernels.round3_quotient_device``: the nine
        proof-independent rows are transformed once per proving key and
        placement and kept there in their sharded cyclic layout."""
        n = args[-1]
        m = 4 * n
        if not self._can_shard(m):
            return super().round3_quotient(*args, pk_cache=pk_cache)
        polys = [self._dpoly(p) for p in args[:15]]
        a_c, b_c, c_c, z_c, _, s1_c, s2_c, s3_c, ql_c, qr_c, qm_c, qo_c, qc_c, pi_c, l1_c = polys
        beta, gamma, alpha, k1, k2 = args[15:20]
        zh_inv, gpow, ginvpow, dpow = self._r3_cyclic_consts(m)
        key = (m, self.mesh.key)
        fixed = pk_cache.coset_rows if pk_cache is not None else None
        if fixed is None or fixed[0] != key:
            fixed = (key, self._coset_dntt([s1_c, s2_c, s3_c, ql_c, qr_c, qm_c, qo_c, qc_c, l1_c], m, gpow))
            if pk_cache is not None:
                pk_cache.coset_rows = fixed
        live = self._coset_dntt([a_c, b_c, c_c, z_c, pi_c], m, gpow)
        sc = scalars((beta, gamma, alpha, alpha * alpha, k1, k2), self.device)
        # z(w x) at natural k is z at k + 4: on shard (d + 4) mod D, (d + 4) div D lanes on
        D = self.D
        zw = self.mesh.ppermute([x[:, 3] for x in live], lambda d: (d + 4) % D)
        tE = [
            round3_combine(x, f, zh, dp, sc.to(dev), (d + 4) // D, z)
            for d, dev, x, f, zh, dp, z in zip(self.mesh.ids, self.mesh.devices, live, fixed[1], zh_inv, dpow, zw)
        ]
        t = dntt._local_fourstep_dual([x[:, None] for x in tE], self.mesh)  # natural block order
        t = self.mesh.gather([_mm(x[:, 0], g) for x, g in zip(t, ginvpow)])
        if _debug_asserts():
            assert not bool(t[:, 3 * n + 6 :].any()), "constraint polynomial not divisible by Z_H"
        return DPoly(t[:, : 3 * n + 6].contiguous(), Basis.MONOMIAL)
