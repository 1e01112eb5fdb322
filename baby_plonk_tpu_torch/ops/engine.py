"""Compute-engine interface: the prover's hot paths behind one contract.

Counterpart of ``baby_plonk_tpu/ops/engine.py``. Three implementations:
  * HostEngine  — exact Python-int oracle (this module), which the port
    is held against;
  * TorchEngine — PyTorch tensors and this package's CUDA kernels
    (ops/torch_engine.py), byte-identical proofs;
  * MeshEngine  — TorchEngine sharded over a device mesh
    (parallel/mesh_engine.py), byte-identical proofs.

Contract (all Fr values are canonical Python ints on the boundary):
  intt(values)                          Lagrange -> monomial coefficients
  ntt(values)                           monomial -> evaluations
  commit(setup, poly)                   KZG MSM commit -> G1
  grand_product(...)                    round-2 running product, n+1 values
"""
from __future__ import annotations

from ..fields import fr
from ..curves import msm_host
from ..protocol import poly as hostpoly

Q = fr.Q


class HostEngine:
    name = "host"

    def intt(self, values: list[int]) -> list[int]:
        return hostpoly.i_ntt(values)

    def ntt(self, values: list[int]) -> list[int]:
        return hostpoly.ntt(values)

    # -- polynomial factory (host Poly / device DPoly share one interface) ----

    def poly(self, values, basis):
        return hostpoly.Poly(list(values), basis)

    def vanishing(self, n: int):
        return hostpoly.vanishing_poly(n)

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
