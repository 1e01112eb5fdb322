"""The 5-round PLONK prover (counterpart of
``baby_plonk_tpu/protocol/prover.py``).

Functional equivalent of src/prover.rs:106-675 with device-friendly
algorithms: O(n log n) NTTs, batch-inverted grand product, exact
vanishing-polynomial division by recurrence, synthetic division for the
opening quotients. Protocol-level behavior (blinding structure, coset
constants k1 = 2 / k2 = 3, transcript schedule, public-input polynomial
convention) matches the reference exactly so proofs cross-verify.

Round map (reference lines):
  round 1  prover.rs:177-277   witness polys a, b, c; blind by Z_H; commit
  round 2  prover.rs:279-368   permutation grand product z; commit
  round 3  prover.rs:370-500   quotient t = all_constraints / Z_H; split; commit
  round 4  prover.rs:502-541   openings at zeta
  round 5  prover.rs:543-647   linearization r, W_zeta, W_zeta_omega; commit

The heavy lifting (NTT, MSM, grand product) dispatches through an
``engine`` so the same protocol logic runs on the host oracle or on the
CUDA device (ops/engine.py; the default is ``TorchEngine("cuda")``).
"""
from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..fields import fr
from ..curves.g1 import G1
from .poly import Basis, Poly
from .program import Program
from .proof import Proof
from .setup import Setup
from .transcript import PlonkTranscript

Q = fr.Q

K1 = 2  # coset constants (prover.rs:99-100)
K2 = 3


@dataclass
class Challenges:
    beta: int = 0
    gamma: int = 0
    alpha: int = 0
    zeta: int = 0
    nu: int = 0
    mu: int = 0


class Prover:
    def __init__(self, setup: Setup, program: Program, engine=None):
        self.setup = setup
        self.program = program
        self.group_order = program.group_order
        self.pk = program.common_preprocessed_input()
        if engine is None:
            from ..ops.engine import get_default_engine

            engine = get_default_engine()
        self.engine = engine

    # -- engine dispatch helpers ------------------------------------------------

    def _intt(self, p):
        assert p.basis == Basis.LAGRANGE
        from ..utils.metrics import get_metrics

        with get_metrics().span("prover.intt"):
            return self.engine.intt_poly(p)

    def _poly(self, values, basis):
        return self.engine.poly(values, basis)

    def _commit(self, p: Poly) -> G1:
        from ..utils.metrics import get_metrics

        with get_metrics().span("prover.commit"):
            return self.engine.commit(self.setup, p)

    def _commit_many(self, ps) -> list:
        """Batch a round's commitments: every MSM dispatches before the
        single result fetch (engine.commit_many) — one host<->device
        round trip per round instead of one per polynomial."""
        from ..utils.metrics import get_metrics

        with get_metrics().span("prover.commit"):
            return self.engine.commit_many(self.setup, ps)

    def prove(
        self,
        witness: dict[str, int],
        blinding: list[int] | None = None,
    ) -> Proof:
        """Produce a proof for ``witness``; optionally injectable blinding
        (11 scalars, prover.rs:108-110) for deterministic tests."""
        n = self.group_order
        if blinding is None:
            blinding = [secrets.randbelow(Q) for _ in range(11)]
            mesh = getattr(self.engine, "mesh", None)
            if mesh is not None:  # the processes of a mesh prove one proof: one draw for all
                blinding = mesh.agree(blinding)
        assert len(blinding) == 11
        self.blinding = [b % Q for b in blinding]
        self.witness = {k: v % Q for k, v in witness.items()}

        transcript = PlonkTranscript(b"plonk")
        ch = Challenges()
        self.ch = ch

        # public-input polynomial: negated public witness values in the first
        # rows, zero elsewhere (prover.rs:114-127)
        public_vars = self.program.get_public_assignment()
        pi_values = [(-self.witness[v]) % Q for v in public_vars]
        pi_values += [0] * (n - len(pi_values))
        self.public_input_poly = self._poly(pi_values, Basis.LAGRANGE)

        from ..utils.metrics import get_metrics

        m = get_metrics()
        with m.span("prover.round_1"):
            a_1, b_1, c_1 = self.round_1()
        ch.beta, ch.gamma = transcript.round_1(a_1, b_1, c_1)

        with m.span("prover.round_2"):
            z_1 = self.round_2()
        ch.alpha = transcript.round_2(z_1)

        with m.span("prover.round_3"):
            t_lo_1, t_mid_1, t_hi_1 = self.round_3()
        ch.zeta = transcript.round_3(t_lo_1, t_mid_1, t_hi_1)

        with m.span("prover.round_4"):
            evals = self.round_4()
        ch.nu = transcript.round_4(*evals)

        with m.span("prover.round_5"):
            w_zeta_1, w_zeta_omega_1 = self.round_5()
        ch.mu = transcript.round_5(w_zeta_1, w_zeta_omega_1)

        return Proof(
            a_1=a_1, b_1=b_1, c_1=c_1, z_1=z_1,
            t_lo_1=t_lo_1, t_mid_1=t_mid_1, t_hi_1=t_hi_1,
            w_zeta_1=w_zeta_1, w_zeta_omega_1=w_zeta_omega_1,
            a_bar=evals[0], b_bar=evals[1], c_bar=evals[2],
            s1_bar=evals[3], s2_bar=evals[4], z_omega_bar=evals[5],
        )

    # -- round 1 ------------------------------------------------------------------

    def round_1(self):
        n = self.group_order
        w = self.witness

        def col(wire_getter):
            vals = [0] * n
            for i, constraint in enumerate(self.program.constraints):
                name = wire_getter(constraint)
                if name is not None:
                    if name not in w:
                        raise KeyError(
                            f"witness missing variable {name!r} (constraint row {i})"
                        )
                    vals[i] = w[name]
            return vals

        a_values = col(lambda c: c.wires.L)
        b_values = col(lambda c: c.wires.R)
        c_values = col(lambda c: c.wires.O)

        b1, b2, b3, b4, b5, b6 = self.blinding[:6]

        self.a_values, self.b_values, self.c_values = a_values, b_values, c_values
        self.a = self._poly(a_values, Basis.LAGRANGE)
        self.b = self._poly(b_values, Basis.LAGRANGE)
        self.c = self._poly(c_values, Basis.LAGRANGE)

        # blinding polys are (b2 + b1 x), (b4 + b3 x), (b6 + b5 x), each
        # multiplied by Z_H = x^n - 1 (prover.rs:241-247). The product has
        # the closed form -b_lo - b_hi x + b_lo x^n + b_hi x^(n+1), so no
        # polynomial multiplication (and no NTT) is needed.
        def blind_zh(coeffs: list[int]):
            lo = [(-c) % Q for c in coeffs]
            return self._poly(
                lo + [0] * (n - len(coeffs)) + coeffs, Basis.MONOMIAL
            )

        self.a_coeff = blind_zh([b2, b1]) + self._intt(self.a)
        self.b_coeff = blind_zh([b4, b3]) + self._intt(self.b)
        self.c_coeff = blind_zh([b6, b5]) + self._intt(self.c)
        self._blind_zh = blind_zh

        return tuple(self._commit_many([self.a_coeff, self.b_coeff, self.c_coeff]))

    # -- round 2 ------------------------------------------------------------------

    def round_2(self):
        n = self.group_order
        beta, gamma = self.ch.beta, self.ch.gamma
        from ..config import get_config

        gp_dev = getattr(self.engine, "grand_product_poly", None)
        if gp_dev is not None:
            # device-resident fast path: a/b/c stay on device, σ and the roots are
            # cached packed, the single inversion runs on device — no
            # O(n) host<->device int round trips
            z_poly, closing = gp_dev(
                self.a, self.b, self.c, self.pk, beta, gamma, K1, K2
            )
            if get_config().debug_asserts:
                # sanity: full cycle returns to 1 (prover.rs:319)
                from ..ops.limbs import FR

                assert FR.unpack_mont(closing) == [1], "grand product does not close"
            b7, b8, b9 = self.blinding[6:9]
            self.z = z_poly
            self.z_coeff = self._blind_zh([b9, b8, b7]) + self._intt(self.z)
            return self._commit(self.z_coeff)

        roots = fr.roots_of_unity(n)
        a, b, c = self.a_values, self.b_values, self.c_values
        s1, s2, s3 = self.pk.s1.values, self.pk.s2.values, self.pk.s3.values

        z_values = self.engine.grand_product(
            a, b, c, s1, s2, s3, roots, beta, gamma, K1, K2
        )
        # sanity: full cycle returns to 1 (prover.rs:319)
        if get_config().debug_asserts:
            assert z_values[-1] == 1, "grand product does not close"
        z_values = z_values[:-1]

        b7, b8, b9 = self.blinding[6:9]
        self.z = self._poly(z_values, Basis.LAGRANGE)
        # blinding poly b9 + b8 x + b7 x^2 (prover.rs:359), times Z_H in
        # closed form (see round_1)
        self.z_coeff = self._blind_zh([b9, b8, b7]) + self._intt(self.z)
        return self._commit(self.z_coeff)

    # -- round 3 ------------------------------------------------------------------

    def round_3(self):
        n = self.group_order
        ch = self.ch
        beta, gamma, alpha = ch.beta, ch.gamma, ch.alpha

        pk = self.pk
        # one batched iNTT for all 8 preprocessed columns (the reference
        # converts them one by one, prover.rs:374-397); fixed per proving
        # key, so cached there (keyed by engine to keep host/device
        # representations separate)
        cache = pk.coeff_cache
        ekey = getattr(self.engine, "name", "host")
        if ekey not in cache:
            cache[ekey] = self.engine.intt_polys(
                [pk.s1, pk.s2, pk.s3, pk.ql, pk.qr, pk.qm, pk.qo, pk.qc]
            )
        s1_c, s2_c, s3_c, ql_c, qr_c, qm_c, qo_c, qc_c = cache[ekey]
        self.s1_coeff, self.s2_coeff, self.s3_coeff = s1_c, s2_c, s3_c
        self.ql_coeff, self.qr_coeff, self.qm_coeff = ql_c, qr_c, qm_c
        self.qo_coeff, self.qc_coeff = qo_c, qc_c

        a_c, b_c, c_c, z_c = self.a_coeff, self.b_coeff, self.c_coeff, self.z_coeff

        self.pi_coeff = self._intt(self.public_input_poly)
        omega = fr.root_of_unity(n)
        z_omega_c = z_c.scale_domain(omega)
        self.z_omega_coeff = z_omega_c
        l1_c = self._l1_coeff()

        t_coeff = None
        if hasattr(self.engine, "round3_quotient"):
            # fused device path: one batched coset NTT + pointwise
            # combination + pointwise Z_H division + one inverse NTT
            t_coeff = self.engine.round3_quotient(
                a_c, b_c, c_c, z_c, z_omega_c, s1_c, s2_c, s3_c,
                ql_c, qr_c, qm_c, qo_c, qc_c, self.pi_coeff, l1_c,
                beta, gamma, alpha, K1, K2, n,
                pk_cache=self.pk,
            )
        if t_coeff is None:
            gate = (
                a_c * ql_c
                + b_c * qr_c
                + a_c * b_c * qm_c
                + c_c * qo_c
                + self.pi_coeff
                + qc_c
            )

            # iNTT of the identity permutation values w^i is the polynomial x
            x_poly = self._poly([0, 1], Basis.MONOMIAL)

            perm_grand = (
                a_c.rlc(x_poly, beta, gamma)
                * b_c.rlc(x_poly * K1, beta, gamma)
                * c_c.rlc(x_poly * K2, beta, gamma)
            ) * z_c - (
                a_c.rlc(s1_c, beta, gamma)
                * b_c.rlc(s2_c, beta, gamma)
                * c_c.rlc(s3_c, beta, gamma)
            ) * z_omega_c

            perm_first_row = (z_c - 1) * l1_c

            all_constraints = (
                gate + perm_grand * alpha + perm_first_row * (alpha * alpha % Q)
            )
            t_coeff = all_constraints.divide_by_vanishing(n)

        # split into t_lo | t_mid | t_hi at n, 2n (prover.rs:649-659)
        t_lo = t_coeff.slice_coeffs(0, n)
        t_mid = t_coeff.slice_coeffs(n, 2 * n)
        t_hi = t_coeff.slice_coeffs(2 * n, max(len(t_coeff), 2 * n + 1))

        # cross-blinding (prover.rs:470-481)
        b10, b11 = self.blinding[9], self.blinding[10]
        x_n = self._poly([0] * n + [1], Basis.MONOMIAL)
        t_lo = t_lo + x_n * b10
        t_mid = t_mid + x_n * b11 - b10
        t_hi = t_hi - b11

        self.t_lo_coeff, self.t_mid_coeff, self.t_hi_coeff = t_lo, t_mid, t_hi
        return tuple(self._commit_many([t_lo, t_mid, t_hi]))

    def _l1_coeff(self):
        if getattr(self, "_l1_c", None) is None:
            n = self.group_order
            self._l1_c = self._intt(self._poly([1] + [0] * (n - 1), Basis.LAGRANGE))
        return self._l1_c

    # -- round 4 ------------------------------------------------------------------

    def round_4(self):
        zeta = self.ch.zeta
        # one batched evaluation kernel for the 6 openings (the reference
        # evaluates one by one, prover.rs:502-541) — plus L1(zeta) and
        # PI(zeta), which round 5 needs at the same point
        polys = [
            self.a_coeff, self.b_coeff, self.c_coeff,
            self.s1_coeff, self.s2_coeff, self.z_omega_coeff,
            self._l1_coeff(), self.pi_coeff,
        ]
        evals = self.engine.eval_polys(polys, zeta)
        self.evals = tuple(evals[:6])
        self._l1_zeta, self._pi_zeta = evals[6], evals[7]
        return self.evals

    # -- round 5 ------------------------------------------------------------------

    def round_5(self):
        """Linearization + opening quotients (prover.rs:543-647).

        The polynomial  W_zeta_num = r + sum_i nu^i (p_i - pbar_i)  is a
        single linear combination  sum_j c_j * P_j + const  with scalar
        coefficients computable on the host, so the whole round makes one
        fused combine (engine.linear_combine) and two synthetic divisions
        instead of ~15 polynomial ops:
          r = r1 + alpha r2 + alpha^2 r3 - r4 expands to rows
          {qm, ql, qr, qo, qc, z, s3, t_lo, t_mid, t_hi} and a constant;
          the nu-fold adds rows {a, b, c, s1, s2}.
        """
        n = self.group_order
        ch = self.ch
        alpha, beta, gamma, zeta, nu = ch.alpha, ch.beta, ch.gamma, ch.zeta, ch.nu
        a_bar, b_bar, c_bar, s1_bar, s2_bar, z_omega_bar = self.evals

        z_c = self.z_coeff
        l1_zeta = self._l1_zeta
        zeta_n = pow(zeta, n, Q)
        z_h_zeta = (zeta_n - 1) % Q
        # r2 = z * v2 - (beta*s3 + (c_bar + gamma)) * w3 where
        v2 = (
            (a_bar + zeta * beta + gamma)
            * (b_bar + zeta * beta * K1 + gamma)
            % Q
            * (c_bar + zeta * beta * K2 + gamma)
            % Q
        )
        w3 = (
            (a_bar + s1_bar * beta + gamma)
            * (b_bar + s2_bar * beta + gamma)
            % Q
            * z_omega_bar
            % Q
        )
        alpha2 = alpha * alpha % Q
        nus = [pow(nu, i, Q) for i in range(6)]

        rows = [
            self.qm_coeff, self.ql_coeff, self.qr_coeff, self.qo_coeff,
            self.qc_coeff, z_c, self.s3_coeff,
            self.t_lo_coeff, self.t_mid_coeff, self.t_hi_coeff,
            self.a_coeff, self.b_coeff, self.c_coeff,
            self.s1_coeff, self.s2_coeff,
        ]
        coeffs = [
            a_bar * b_bar % Q, a_bar, b_bar, c_bar,
            1, (alpha * v2 + alpha2 * l1_zeta) % Q, (-alpha * beta % Q) * w3 % Q,
            -z_h_zeta % Q, -z_h_zeta * zeta_n % Q, -z_h_zeta * zeta_n % Q * zeta_n % Q,
            nus[1], nus[2], nus[3], nus[4], nus[5],
        ]
        const = (
            self._pi_zeta
            - alpha * w3 % Q * ((c_bar + gamma) % Q)
            - alpha2 * l1_zeta
            - (
                nus[1] * a_bar + nus[2] * b_bar + nus[3] * c_bar
                + nus[4] * s1_bar + nus[5] * s2_bar
            )
        ) % Q
        w_zeta_num = self.engine.linear_combine(rows, coeffs, const)

        from ..config import get_config

        if get_config().debug_asserts:
            # r(zeta) = 0 (prover.rs:615)  <=>  w_zeta_num(zeta) = 0, since
            # the nu-fold terms vanish at zeta by construction; also
            # enforced by divide_by_linear's exactness check below.
            assert w_zeta_num.eval(zeta) == 0, (
                "linearization poly must vanish at zeta (prover.rs:615)"
            )

        w_zeta = w_zeta_num.divide_by_linear(zeta)

        omega = fr.root_of_unity(n)
        w_zeta_omega = (z_c - z_omega_bar).divide_by_linear(zeta * omega % Q)

        return tuple(self._commit_many([w_zeta, w_zeta_omega]))
