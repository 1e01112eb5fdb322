"""The port's compute engine: the engine contract (``ops/engine.py``) on
PyTorch tensors, as ``TpuEngine`` (``baby_plonk_tpu/ops/tpu_engine.py``)
on JAX arrays.

``TorchEngine("cuda")`` runs every field, NTT and point operation as a
launch of this package's CUDA kernels; ``TorchEngine("cpu")`` runs their
plain PyTorch versions (the CPU tests). There is no fallback between the
two: a CUDA engine without a card raises.

Device state lives on the protocol objects: ``Setup.device_points``
(device SRS), ``Setup.fb_tables`` (commit tables), ``pk.sigma_lagrange``
and ``pk.coset_rows`` (proving-key rows), each keyed by device.
"""
from __future__ import annotations

import torch

from ..fields import fr
from ..protocol.poly import Basis

from ..curves.g1 import G1
from ..utils.metrics import get_metrics
from . import g1_vec, limbs, msm, srs
from .dpoly import DPoly, eval_many
from .limbs import FR
from .msm_fixed import tables_for_setup
from .ntt import ntt_device, ntt_ints
from .prover_kernels import grand_product_fg, linear_combine_device, round3_quotient_device

Q = fr.Q


class TorchEngine:
    name = "torch"

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchEngine('cuda'): no CUDA device is available")
        self._roots: dict[int, torch.Tensor] = {}

    def agree(self, values: list[int]) -> list[int]:
        return values

    # -- NTT ---------------------------------------------------------------------

    def intt(self, values: list[int]) -> list[int]:
        return ntt_ints(values, inverse=True, device=self.device)

    def ntt(self, values: list[int]) -> list[int]:
        return ntt_ints(values, device=self.device)

    # -- polynomial factory --------------------------------------------------------

    def poly(self, values, basis):
        return DPoly.from_ints(list(values), basis, self.device)

    def sparse_poly(self, length: int, entries: dict, basis):
        return DPoly.sparse(length, entries, basis, self.device)

    def wire_columns(self, table, witness):
        """Round 1's Lagrange columns a, b, c on the device from the
        ``witness`` dict (``protocol/program.py::WireTable``): its values in
        ``table.names`` order packed with a zero slot after them, then one
        gather a column by the table's index, uploaded once per device.

        A witness in the key order the table learned is read by one native
        pass (``WireTable.packed``, counted in ``witness_order_hits``);
        any other takes one lookup a name and ``FR.pack_mont``, and teaches
        the table its order (``witness_order_misses``). The spans keep the
        prover's names: the pass or the pack is round 1's
        ``dpoly.from_ints``; the lookups and the gather, ``prover.columns``."""
        m = get_metrics()
        with m.span("dpoly.from_ints"):
            packed = table.packed(witness)
            if packed is not None:
                wit = FR.upload_mont(packed, len(packed), self.device, zeros=1)
        if packed is not None:
            m.count("witness_order_hits")
        else:
            m.count("witness_order_misses")
            with m.span("prover.columns"):
                values = table.values(witness)
                table.learn(witness)
            with m.span("dpoly.from_ints"):
                wit = FR.pack_mont(values, self.device, zeros=1)
        with m.span("prover.columns"):
            key = str(self.device)
            index = table.device_index.get(key)
            if index is None:
                index = table.device_index[key] = limbs.to_device(
                    torch.from_numpy(table.index), self.device, torch.int64)
            n = index.shape[-1]
            cols = [DPoly(torch.gather(wit, 1, row.expand(16, n)), Basis.LAGRANGE) for row in index]
            m.count("device_columns", len(cols))
        return cols

    def _dpoly(self, p) -> DPoly:
        """``p`` on the engine's device: a host ``Poly`` is packed, a DPoly
        is moved if it lies elsewhere (the proving key's coefficient cache
        is keyed by engine name, which all devices share)."""
        if isinstance(p, DPoly):
            return DPoly(p.vals.to(self.device), p.basis)
        return self.poly(p.values, p.basis)

    def intt_poly(self, p):
        return self._dpoly(p).to_monomial()

    def intt_polys(self, ps):
        """One batched (16, k, n) inverse NTT for k same-length polys."""
        ps = [self._dpoly(p) for p in ps]
        assert all(p.basis == Basis.LAGRANGE for p in ps)
        if len({len(p) for p in ps}) != 1:
            return [p.to_monomial() for p in ps]
        out = ntt_device(torch.stack([p.vals for p in ps], dim=1), inverse=True)
        return [DPoly(out[:, i].contiguous(), Basis.MONOMIAL) for i in range(len(ps))]

    # -- KZG commit --------------------------------------------------------------

    def _commit_arrays(self, setup, scalars_raw):
        """Device MSMs of raw scalar limbs [(16, k_i)] against the SRS
        prefixes, (24, P) x3: the fixed-base tables (cached per SRS, all
        polys in one Horner launch) unless the config disables them, else
        the first k_i SRS points through ``msm.msm_device_arrays``."""
        from ..config import get_config

        if get_config().commit_fixed_base:
            return tables_for_setup(setup, self.device).msm_many(scalars_raw)
        pts = srs.setup_points(setup, self.device)
        outs = [
            msm.msm_device_arrays(tuple(c[:, : s.shape[-1]] for c in pts), s)
            for s in scalars_raw
        ]
        return tuple(torch.stack([o[k] for o in outs], dim=-1) for k in range(3))

    def commit(self, setup, polynomial):
        return self.commit_many(setup, [polynomial])[0]

    def commit_many(self, setup, polys):
        """All commits of a round with one host transfer. A host ``Poly``
        is trimmed of trailing zeros, and an all-zero one commits to the
        identity without a launch."""
        scalars, live = [], []
        for i, p in enumerate(polys):
            assert p.basis == Basis.MONOMIAL
            if isinstance(p, DPoly):
                raw = limbs.from_mont(FR, p.vals.to(self.device))
            else:
                values = list(p.values)
                while values and values[-1] == 0:
                    values.pop()
                if not values:
                    continue
                raw = FR.pack_raw(values, self.device)
            assert raw.shape[-1] <= setup.srs_len(), (
                f"polynomial length {raw.shape[-1]} exceeds SRS size"
            )
            scalars.append(raw)
            live.append(i)
        out = [G1.identity()] * len(polys)
        if live:
            pts = g1_vec.points_from_device(self._commit_arrays(setup, scalars))
            for i, pt in zip(live, pts):
                out[i] = pt
        return out

    # -- evaluations and fused rounds --------------------------------------------

    def eval_polys(self, polys, x: int) -> list[int]:
        return eval_many([self._dpoly(p) for p in polys], x)

    def linear_combine(self, polys, coeffs, const):
        return linear_combine_device([self._dpoly(p) for p in polys], coeffs, const)

    def round3_quotient(self, *args, **kwargs):
        """Coset-domain quotient (ops/prover_kernels.py)."""
        polys = [self._dpoly(p) for p in args[:15]]
        return round3_quotient_device(*polys, *args[15:], **kwargs)

    # -- grand product -----------------------------------------------------------

    def _roots_mont(self, n: int) -> torch.Tensor:
        r = self._roots.get(n)
        if r is None:
            r = self._roots[n] = FR.pack_mont(fr.roots_of_unity(n), self.device)
        return r

    def _grand_product(self, a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2):
        """(z (16, n) with z[0] = 1, closing z_n (16, 1)); all Montgomery.
        z_i = prod_{j<i} f_j / g_j with one field inversion, as
        ``tpu_engine._grand_product_full``: z_i = (f_0 .. f_{i-1})
        (g_i .. g_{n-1}) / (g_0 .. g_{n-1}). The exclusive prefix of f and the
        suffix of g are one scan each, with the totals of both: the
        reference's third scan and its shifts by one were only another
        reading of the same products."""
        mul = lambda x, y: limbs.mont_mul(FR, x, y)
        f, g = grand_product_fg(a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2)
        pre_f, total_f = limbs.field_scan(FR, f, "mul", exclusive=True)
        suf_g, total_g = limbs.field_scan(FR, g, "mul", reverse=True)
        total_inv = limbs.mont_pow_fixed(FR, total_g, Q - 2)
        return mul(mul(pre_f, suf_g), total_inv), mul(total_f, total_inv)

    def grand_product(self, a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2) -> list[int]:
        pk = lambda v: FR.pack_mont(v, self.device)
        z, closing = self._grand_product(
            pk(a), pk(b), pk(c), pk(s1), pk(s2), pk(s3), pk(roots), beta, gamma, k1, k2
        )
        return FR.unpack_mont(torch.cat([z, closing], dim=-1))

    def grand_product_poly(self, a, b, c, pk, beta, gamma, k1, k2):
        """Round 2 on the device: the prover's Lagrange DPolys in, (z, the
        closing z_n) out as Lagrange DPolys; sigma columns packed once per pk."""
        n = len(a)
        cache = pk.sigma_lagrange
        key = (str(self.device), n)
        sig = cache.get(key)
        if sig is None:
            sig = cache[key] = tuple(
                FR.pack_mont(p.values, self.device) for p in (pk.s1, pk.s2, pk.s3)
            )
        z, closing = self._grand_product(
            a.vals, b.vals, c.vals, *sig, self._roots_mont(n), beta, gamma, k1, k2
        )
        return DPoly(z, Basis.LAGRANGE), DPoly(closing, Basis.LAGRANGE)
