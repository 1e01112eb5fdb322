"""Compute-engine interface: all that ``protocol/`` asks of an engine.

Counterpart of ``baby_plonk_tpu/ops/engine.py``. Three implementations,
each with the whole contract and byte-identical proofs:
  * HostEngine  — exact Python-int oracle (this module), which the port
    is held against;
  * TorchEngine — PyTorch tensors and this package's CUDA kernels
    (ops/torch_engine.py);
  * MeshEngine  — TorchEngine sharded over a device mesh
    (parallel/mesh_engine.py).

The contract: the only calls the prover and the verifier make (Fr values
are canonical Python ints on the boundary; "poly" is the engine's own
polynomial type, host ``Poly`` or device ``DPoly``, which share one
interface):
  name                                  key of the proving key's caches
  poly(values, basis)                   a poly from ints
  sparse_poly(length, entries, basis)   a poly zero but at a few positions
  intt_poly(p) / intt_polys(ps)         Lagrange -> monomial
  commit(setup, p) / commit_many(...)   KZG commits -> G1
  eval_polys(polys, x)                  evaluations at one point -> ints
  linear_combine(polys, coeffs, const)  sum_i coeffs[i] polys[i] + const
  wire_columns(table, witness)          round 1: the Lagrange columns a, b, c
  grand_product_poly(a, b, c, pk, ...)  round 2: (z, closing z_n as a
                                        one-value poly)
  round3_quotient(..., n, pk_cache)     round 3: t = constraints / Z_H
  agree(values)                         the blinding every process uses

The list-level ``intt``, ``ntt`` and ``grand_product`` are the JAX
engine's methods, which the tests hold against JAX; no protocol code
calls them.
"""
from __future__ import annotations

from ..fields import fr
from ..protocol import poly as hostpoly
from ..utils.metrics import get_metrics

Q = fr.Q


class HostEngine:
    name = "host"

    def agree(self, values: list[int]) -> list[int]:
        return values

    def intt(self, values: list[int]) -> list[int]:
        return hostpoly.i_ntt(values)

    def ntt(self, values: list[int]) -> list[int]:
        return hostpoly.ntt(values)

    # -- polynomial factory (host Poly / device DPoly share one interface) ----

    def poly(self, values, basis):
        return hostpoly.Poly(list(values), basis)

    def sparse_poly(self, length: int, entries: dict, basis):
        """``length`` values, zero but at ``entries`` (position -> int); the
        device engine uploads only the entries."""
        values = [0] * length
        for i, v in entries.items():
            values[i] = v % Q
        return hostpoly.Poly(values, basis)

    def wire_columns(self, table, witness):
        """Round 1's Lagrange columns a, b, c: the witness's values in
        ``table.names`` order (``WireTable.values``, which names a missing
        variable) reduced, a zero slot after them, read by ``table.index``."""
        with get_metrics().span("prover.columns"):
            vals = [v % Q for v in table.values(witness)] + [0]
            return [hostpoly.Poly([vals[k] for k in row], hostpoly.Basis.LAGRANGE) for row in table.index.tolist()]

    def intt_poly(self, p):
        """Lagrange poly object -> monomial poly object."""
        assert p.basis == hostpoly.Basis.LAGRANGE
        return hostpoly.Poly(hostpoly.i_ntt(p.values), hostpoly.Basis.MONOMIAL)

    def intt_polys(self, ps):
        """Batched variant (one device round-trip on the device engine)."""
        return [self.intt_poly(p) for p in ps]

    def commit(self, setup, polynomial):
        return setup.commit(polynomial)

    def commit_many(self, setup, polys):
        """Batched variant (one device round-trip on the device engine)."""
        return [self.commit(setup, p) for p in polys]

    def eval_polys(self, polys, x: int) -> list[int]:
        """Evaluate monomial polys at x (the device engine batches this)."""
        return [p.eval(x) for p in polys]

    def linear_combine(self, polys, coeffs: list[int], const: int):
        """sum_i coeffs[i] * polys[i] + const (monomial). The device engine
        fuses this into one kernel; prover round 5 is one such sum."""
        out = None
        for p, c in zip(polys, coeffs):
            term = p * c
            out = term if out is None else out + term
        return out + const

    def grand_product(
        self, a, b, c, s1, s2, s3, roots, beta, gamma, k1, k2
    ) -> list[int]:
        """z_0 = 1; z_{i+1} = z_i * f_i / g_i where
        f_i = rlc(a_i, w^i) rlc(b_i, k1 w^i) rlc(c_i, k2 w^i),
        g_i = rlc(a_i, s1_i) rlc(b_i, s2_i) rlc(c_i, s3_i)   (prover.rs:286-317).

        Uses prefix products + Montgomery batch inversion rather than the
        reference's 3n serial inversions."""
        n = len(roots)
        rl = hostpoly.rlc_scalar
        f = [
            rl(a[i], roots[i], beta, gamma)
            * rl(b[i], roots[i] * k1 % Q, beta, gamma)
            % Q
            * rl(c[i], roots[i] * k2 % Q, beta, gamma)
            % Q
            for i in range(n)
        ]
        g = [
            rl(a[i], s1[i], beta, gamma)
            * rl(b[i], s2[i], beta, gamma)
            % Q
            * rl(c[i], s3[i], beta, gamma)
            % Q
            for i in range(n)
        ]
        # prefix products
        pf = [1] * (n + 1)
        pg = [1] * (n + 1)
        for i in range(n):
            pf[i + 1] = pf[i] * f[i] % Q
            pg[i + 1] = pg[i] * g[i] % Q
        pg_inv = fr.batch_inv(pg[1:])
        z = [1] + [pf[i + 1] * pg_inv[i] % Q for i in range(n)]
        return z

    def grand_product_poly(self, a, b, c, pk, beta, gamma, k1, k2):
        """Round 2: (z as a Lagrange poly, the closing z_n as a one-value
        poly) from ``grand_product`` over the Lagrange columns."""
        n = len(a)
        z = self.grand_product(a.values, b.values, c.values, pk.s1.values, pk.s2.values, pk.s3.values,
                               fr.roots_of_unity(n), beta, gamma, k1, k2)
        return hostpoly.Poly(z[:n], hostpoly.Basis.LAGRANGE), hostpoly.Poly(z[n:], hostpoly.Basis.LAGRANGE)

    def round3_quotient(self, a, b, c, z, zw, s1, s2, s3, ql, qr, qm, qo, qc, pi, l1,
                        beta, gamma, alpha, k1, k2, n, pk_cache=None):
        """Round 3's quotient by polynomial products (prover.rs:370-468):
        (gate + alpha perm + alpha^2 (z - 1) L1) / Z_H from the monomial
        operands; ``pk_cache`` is the device engines' and unused here."""
        gate = a * ql + b * qr + a * b * qm + c * qo + pi + qc
        x = hostpoly.Poly([0, 1], hostpoly.Basis.MONOMIAL)  # the iNTT of the identity permutation w^i
        perm = (a.rlc(x, beta, gamma) * b.rlc(x * k1, beta, gamma) * c.rlc(x * k2, beta, gamma)) * z - (
            a.rlc(s1, beta, gamma) * b.rlc(s2, beta, gamma) * c.rlc(s3, beta, gamma)) * zw
        return (gate + perm * alpha + (z - 1) * l1 * (alpha * alpha % Q)).divide_by_vanishing(n)


_default_engine: object | None = None


def get_default_engine():
    """``TorchEngine("cuda")`` (raises without a card) unless BPT_ENGINE
    selects "host" or "mesh" (``MeshEngine`` over ``make_mesh`` of
    ``Config.mesh_devices`` shards, on the cards)."""
    global _default_engine
    if _default_engine is None:
        from ..config import get_config

        name = get_config().engine
        if name == "torch":
            from .torch_engine import TorchEngine

            _default_engine = TorchEngine("cuda")
        elif name == "host":
            _default_engine = HostEngine()
        elif name == "mesh":
            from ..parallel.mesh import make_mesh
            from ..parallel.mesh_engine import MeshEngine

            _default_engine = MeshEngine(make_mesh(get_config().mesh_devices))
        else:
            raise ValueError(f"unknown engine {name!r}: expected 'torch', 'host' or 'mesh'")
    return _default_engine


def set_default_engine(engine) -> None:
    global _default_engine
    _default_engine = engine
