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

The heavy lifting (columns, NTT, MSM, grand product, quotient) is one
call a step to an ``engine`` (the contract in ops/engine.py), so one
path runs on the host oracle, on the CUDA device or over a mesh (the
default is ``TorchEngine("cuda")``).
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
from ..utils.metrics import get_metrics

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
        with get_metrics().span("prover.intt"):
            return self.engine.intt_poly(p)

    def _commit(self, p: Poly) -> G1:
        with get_metrics().span("prover.commit"):
            return self.engine.commit(self.setup, p)

    def _commit_many(self, ps) -> list:
        """Batch a round's commitments: every MSM dispatches before the
        single result fetch (engine.commit_many) — one host<->device
        round trip per round instead of one per polynomial."""
        with get_metrics().span("prover.commit"):
            return self.engine.commit_many(self.setup, ps)

    def prove(
        self,
        witness: dict[str, int],
        blinding: list[int] | None = None,
    ) -> Proof:
        """Produce a proof for ``witness``; optionally injectable blinding
        (11 scalars, prover.rs:108-110) for deterministic tests. The spans
        of one call carry its proof id (``utils.metrics.Metrics.proof``)."""
        m = get_metrics()
        with m.proof():
            return self._prove(m, witness, blinding)

    def _prove(self, m, witness, blinding) -> Proof:
        n = self.group_order
        transcript = PlonkTranscript(b"plonk")
        ch = Challenges()
        self.ch = ch

        with m.span("prover.prepare"):
            if blinding is None:
                blinding = self.engine.agree([secrets.randbelow(Q) for _ in range(11)])
            assert len(blinding) == 11
            self.blinding = [b % Q for b in blinding]
            self.witness = witness

            # public-input polynomial: negated public witness values in the
            # first rows, zero elsewhere (prover.rs:114-127)
            public_vars = self.program.get_public_assignment()
            self.public_input_poly = self.engine.sparse_poly(
                n, {i: -witness[v] for i, v in enumerate(public_vars)}, Basis.LAGRANGE
            )

        with m.span("prover.round_1"):
            a_1, b_1, c_1 = self.round_1()
        with m.span("prover.transcript"):
            ch.beta, ch.gamma = transcript.round_1(a_1, b_1, c_1)

        with m.span("prover.round_2"):
            z_1 = self.round_2()
        with m.span("prover.transcript"):
            ch.alpha = transcript.round_2(z_1)

        with m.span("prover.round_3"):
            t_lo_1, t_mid_1, t_hi_1 = self.round_3()
        with m.span("prover.transcript"):
            ch.zeta = transcript.round_3(t_lo_1, t_mid_1, t_hi_1)

        with m.span("prover.round_4"):
            evals = self.round_4()
        with m.span("prover.transcript"):
            ch.nu = transcript.round_4(*evals)

        with m.span("prover.round_5"):
            w_zeta_1, w_zeta_omega_1 = self.round_5()
        with m.span("prover.transcript"):
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
        # the witness goes to the engine once, read in the program's
        # variable order, and the engine gathers a, b, c from it
        self.a, self.b, self.c = self.engine.wire_columns(self.program.wire_table(), self.witness)
        b1, b2, b3, b4, b5, b6 = self.blinding[:6]
        with get_metrics().span("prover.intt"):
            a_c, b_c, c_c = self.engine.intt_polys([self.a, self.b, self.c])
        self.a_coeff = self._blind_zh([b2, b1]) + a_c
        self.b_coeff = self._blind_zh([b4, b3]) + b_c
        self.c_coeff = self._blind_zh([b6, b5]) + c_c

        return tuple(self._commit_many([self.a_coeff, self.b_coeff, self.c_coeff]))

    def _blind_zh(self, coeffs: list[int]):
        """The blinding polynomial with ``coeffs`` (lowest first) times
        Z_H = x^n - 1 (prover.rs:241-247, 359), in closed form:
        -b_lo - b_hi x + b_lo x^n + b_hi x^(n+1), so no polynomial
        multiplication (and no NTT) is needed."""
        n = self.group_order
        entries = {i: -c for i, c in enumerate(coeffs)}
        entries.update({n + i: c for i, c in enumerate(coeffs)})
        return self.engine.sparse_poly(n + len(coeffs), entries, Basis.MONOMIAL)

    # -- round 2 ------------------------------------------------------------------

    def round_2(self):
        from ..config import get_config

        # one engine call: on a device engine a, b, c stay there, sigma and
        # the roots are cached there and the one inversion runs there
        self.z, closing = self.engine.grand_product_poly(
            self.a, self.b, self.c, self.pk, self.ch.beta, self.ch.gamma, K1, K2
        )
        if get_config().debug_asserts:
            # sanity: full cycle returns to 1 (prover.rs:319)
            assert closing.values == [1], "grand product does not close"
        b7, b8, b9 = self.blinding[6:9]
        # blinding poly b9 + b8 x + b7 x^2 (prover.rs:359), times Z_H in
        # closed form (see round_1)
        self.z_coeff = self._blind_zh([b9, b8, b7]) + self._intt(self.z)
        return self._commit(self.z_coeff)

    # -- round 3 ------------------------------------------------------------------

    def round_3(self):
        n = self.group_order
        ch = self.ch
        beta, gamma, alpha = ch.beta, ch.gamma, ch.alpha

        pre = self.pre = self.pk.coeffs(self.engine)
        a_c, b_c, c_c, z_c = self.a_coeff, self.b_coeff, self.c_coeff, self.z_coeff

        self.pi_coeff = self._intt(self.public_input_poly)
        omega = fr.root_of_unity(n)
        z_omega_c = z_c.scale_domain(omega)
        self.z_omega_coeff = z_omega_c

        t_coeff = self.engine.round3_quotient(
            a_c, b_c, c_c, z_c, z_omega_c, pre.s1, pre.s2, pre.s3,
            pre.ql, pre.qr, pre.qm, pre.qo, pre.qc, self.pi_coeff, self._l1_coeff(),
            beta, gamma, alpha, K1, K2, n,
            pk_cache=self.pk,
        )

        # split into t_lo | t_mid | t_hi at n, 2n (prover.rs:649-659)
        t_lo = t_coeff.slice_coeffs(0, n)
        t_mid = t_coeff.slice_coeffs(n, 2 * n)
        t_hi = t_coeff.slice_coeffs(2 * n, max(len(t_coeff), 2 * n + 1))

        # cross-blinding (prover.rs:470-481)
        b10, b11 = self.blinding[9], self.blinding[10]
        t_lo = t_lo + self.engine.sparse_poly(n + 1, {n: b10}, Basis.MONOMIAL)
        t_mid = t_mid + self.engine.sparse_poly(n + 1, {n: b11}, Basis.MONOMIAL) - b10
        t_hi = t_hi - b11

        self.t_lo_coeff, self.t_mid_coeff, self.t_hi_coeff = t_lo, t_mid, t_hi
        return tuple(self._commit_many([t_lo, t_mid, t_hi]))

    def _l1_coeff(self):
        if getattr(self, "_l1_c", None) is None:
            n = self.group_order
            self._l1_c = self._intt(self.engine.sparse_poly(n, {0: 1}, Basis.LAGRANGE))
        return self._l1_c

    # -- round 4 ------------------------------------------------------------------

    def round_4(self):
        zeta = self.ch.zeta
        # one batched evaluation kernel for the 6 openings (the reference
        # evaluates one by one, prover.rs:502-541) — plus L1(zeta) and
        # PI(zeta), which round 5 needs at the same point
        polys = [
            self.a_coeff, self.b_coeff, self.c_coeff,
            self.pre.s1, self.pre.s2, self.z_omega_coeff,
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

        pre = self.pre
        rows = [
            pre.qm, pre.ql, pre.qr, pre.qo, pre.qc, z_c, pre.s3,
            self.t_lo_coeff, self.t_mid_coeff, self.t_hi_coeff,
            self.a_coeff, self.b_coeff, self.c_coeff, pre.s1, pre.s2,
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
