"""PLONK verifier — steps 4-12 of the PLONK paper.

Functional equivalent of src/verifier.rs. Like the reference, the
verifier preprocessed input is recomputed from the program via 8 KZG
commits (verifier.rs:60-70, so it needs the full SRS — the reference is
deliberately non-succinct here and we preserve that API; the commits
can be cached/shared with the prover's preprocessing).

Final check (verifier.rs:187-191):
  e(W_zeta + mu*W_zeta_omega, x_2)
    == e(zeta*W_zeta + mu*zeta*omega*W_zeta_omega + F_1 - E_1, G_2)
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fields import fr
from ..curves import msm_host
from ..curves.g1 import G1
from ..curves.g2 import G2
from ..curves.pairing import multi_miller_loop, final_exponentiation
from .program import Program
from .proof import Proof
from .setup import Setup
from .transcript import PlonkTranscript

Q = fr.Q
K1, K2 = 2, 3  # verifier.rs:76-77


def _rlc(a: int, b: int, beta: int, gamma: int) -> int:
    return (a + b * beta + gamma) % Q


def _lagrange_evals_at(indices: list[int], zeta: int, n: int, omega: int) -> list[int]:
    """L_i(zeta) for the Lagrange basis over the order-n subgroup {omega^i}:

        L_i(zeta) = omega^i * (zeta^n - 1) / (n * (zeta - omega^i))

    Closed form — O(k) with one batched inversion, replacing the
    reference's iNTT + Horner evaluation (verifier.rs:91-104) which is
    O(n^2) there and O(n log n) + a device round-trip here. Falls back to
    the direct indicator values in the (negligible-probability, zeta is a
    Fiat-Shamir challenge) case where zeta lies on the domain."""
    z_h = (pow(zeta, n, Q) - 1) % Q
    pows = [pow(omega, i, Q) for i in indices]
    if z_h == 0:
        return [1 if zeta == w else 0 for w in pows]
    denoms = fr.batch_inv([(n * (zeta - w)) % Q for w in pows])
    return [w * z_h % Q * d % Q for w, d in zip(pows, denoms)]


@dataclass
class VerifierPreprocessedInput:
    qm_1: G1
    ql_1: G1
    qr_1: G1
    qo_1: G1
    qc_1: G1
    s1_1: G1
    s2_1: G1
    s3_1: G1
    x_2: G2


def preprocessed_input(setup: Setup, program: Program, engine=None):
    """The 8 preprocessed commitments + x_2 (verifier.rs:60-70), computed
    once per (setup, program) pair and cached on the program object — the
    reference recommits on every ``Verifier::new``; these commitments are
    pure functions of the circuit and SRS, so verifying many proofs of the
    same circuit pays the 8 MSMs once."""
    if engine is None:
        from ..ops.engine import get_default_engine

        engine = get_default_engine()
    cache = program.__dict__.setdefault("_vpi_cache", {})
    key = (id(setup), id(engine))
    vpi = cache.get(key)
    if vpi is not None:
        return vpi
    # the proving key's coefficients, shared with a prover of this program on
    # this engine, then 8 commits with ONE device round trip (commit_many)
    coeffs = program.common_preprocessed_input().coeffs(engine)
    points = engine.commit_many(setup, coeffs)
    vpi = VerifierPreprocessedInput(
        **{f"{name}_1": pt for name, pt in zip(coeffs._fields, points)}, x_2=setup.x_2
    )
    cache[key] = vpi
    return vpi


class Verifier:
    def __init__(self, setup: Setup, program: Program, proof: Proof, engine=None):
        if engine is None:
            from ..ops.engine import get_default_engine

            engine = get_default_engine()
        self.engine = engine
        self.vpi = preprocessed_input(setup, program, engine)
        self.proof = proof
        self.group_order = program.group_order

    def compute_challenges(self, proof: Proof):
        """Replay the Fiat-Shamir transcript (verifier.rs:193-209)."""
        t = PlonkTranscript(b"plonk")
        beta, gamma = t.round_1(proof.a_1, proof.b_1, proof.c_1)
        alpha = t.round_2(proof.z_1)
        zeta = t.round_3(proof.t_lo_1, proof.t_mid_1, proof.t_hi_1)
        nu = t.round_4(
            proof.a_bar, proof.b_bar, proof.c_bar,
            proof.s1_bar, proof.s2_bar, proof.z_omega_bar,
        )
        mu = t.round_5(proof.w_zeta_1, proof.w_zeta_omega_1)
        return beta, gamma, alpha, zeta, nu, mu

    def verify(self, public_input: list[int]) -> bool:
        lhs_g1, rhs_g1 = self.final_check_points(public_input)
        f12 = multi_miller_loop([(lhs_g1, self.vpi.x_2), (-rhs_g1, G2.generator())])
        return final_exponentiation(f12).is_one()

    def final_check_points(self, public_input: list[int]) -> tuple[G1, G1]:
        """Steps 4-11 folded into the two G1 points of the final pairing
        equation e(L, x_2) == e(R, G_2); exposed so ``batch_verify`` can
        combine many proofs into ONE pairing check."""
        n = self.group_order
        proof = self.proof
        beta, gamma, alpha, zeta, nu, mu = self.compute_challenges(proof)

        # step 5: Z_H(zeta)
        z_h_zeta = (pow(zeta, n, Q) - 1) % Q

        omega = fr.root_of_unity(n)

        # steps 6-7: L1(zeta) and PI(zeta) in closed form (one batched
        # inversion; the reference does two iNTT+eval passes,
        # verifier.rs:91-104)
        k = len(public_input)
        lag = _lagrange_evals_at(list(range(max(k, 1))), zeta, n, omega)
        l_1_zeta = lag[0]
        pi_eval = 0
        for x, li in zip(public_input, lag):
            pi_eval = (pi_eval - x * li) % Q

        a_bar, b_bar, c_bar = proof.a_bar, proof.b_bar, proof.c_bar
        s1_bar, s2_bar, z_omega_bar = proof.s1_bar, proof.s2_bar, proof.z_omega_bar

        # step 8: r_0
        r_0 = (
            pi_eval
            - l_1_zeta * alpha % Q * alpha
            - alpha
            * _rlc(a_bar, s1_bar, beta, gamma)
            % Q
            * _rlc(b_bar, s2_bar, beta, gamma)
            % Q
            * ((c_bar + gamma) % Q)
            % Q
            * z_omega_bar
        ) % Q

        vpi = self.vpi

        # steps 9-12 folded into ONE Straus multi-exp per pairing operand
        # (the reference does ~15 independent 255-bit scalar muls,
        # verifier.rs:136-179; sharing the doubling chain is ~4x fewer
        # host point ops).
        z_1_scalar = (
            _rlc(a_bar, zeta, beta, gamma)
            * _rlc(b_bar, K1 * zeta % Q, beta, gamma)
            % Q
            * _rlc(c_bar, K2 * zeta % Q, beta, gamma)
            % Q
            * alpha
            + l_1_zeta * alpha % Q * alpha
            + mu
        ) % Q
        s3_scalar = (
            _rlc(a_bar, s1_bar, beta, gamma)
            * _rlc(b_bar, s2_bar, beta, gamma)
            % Q
            * alpha
            % Q
            * beta
            % Q
            * z_omega_bar
            % Q
        )
        nus = [pow(nu, i, Q) for i in range(6)]
        e_scalar = (
            nus[1] * a_bar
            + nus[2] * b_bar
            + nus[3] * c_bar
            + nus[4] * s1_bar
            + nus[5] * s2_bar
            + mu * z_omega_bar
            - r_0
        ) % Q

        terms: list[tuple[G1, int]] = [
            (vpi.qm_1, a_bar * b_bar % Q),
            (vpi.ql_1, a_bar),
            (vpi.qr_1, b_bar),
            (vpi.qo_1, c_bar),
            (vpi.qc_1, 1),
            (proof.z_1, z_1_scalar),
            (vpi.s3_1, (-s3_scalar) % Q),
            (proof.t_lo_1, (-z_h_zeta) % Q),
            (proof.t_mid_1, (-pow(zeta, n, Q) * z_h_zeta) % Q),
            (proof.t_hi_1, (-pow(zeta, 2 * n, Q) * z_h_zeta) % Q),
            (proof.a_1, nus[1]),
            (proof.b_1, nus[2]),
            (proof.c_1, nus[3]),
            (vpi.s1_1, nus[4]),
            (vpi.s2_1, nus[5]),
            (G1.generator(), (-e_scalar) % Q),
            (proof.w_zeta_1, zeta),
            (proof.w_zeta_omega_1, mu * zeta % Q * omega % Q),
        ]
        rhs_g1 = msm_host.multiexp([p for p, _ in terms], [s for _, s in terms])
        lhs_g1 = msm_host.multiexp(
            [proof.w_zeta_1, proof.w_zeta_omega_1], [1, mu]
        )
        return lhs_g1, rhs_g1


def batch_verify(checks: list[tuple["Verifier", list[int]]]) -> bool:
    """Verify many proofs with ONE 2-pairing check.

    ``checks`` is a list of (Verifier, public_input) sharing one SRS (the
    same x_2 = [tau]G_2). Each proof contributes its final-check pair
    (L_i, R_i) with e(L_i, x_2) == e(R_i, G_2); a random linear
    combination r_i (Schwartz–Zippel: if any single check fails, the
    combined one fails except with probability ~k/r) folds them into
      e(sum r_i L_i, x_2) == e(sum r_i R_i, G_2).
    The combiners are derived Fiat–Shamir-style from every proof and
    public input, so a prover cannot craft proofs that cancel.

    The reference has no aggregate path (verifier.rs checks one proof per
    pairing); at k proofs this is 2 pairings instead of 2k.
    """
    import hashlib

    if not checks:
        return True
    x_2 = checks[0][0].vpi.x_2
    assert all(v.vpi.x_2 == x_2 for v, _ in checks), "batch needs one SRS"
    h = hashlib.sha3_256(b"bpt-batch-verify")
    for v, pub in checks:
        h.update(v.proof.to_bytes())
        for x in pub:
            h.update(int(x % Q).to_bytes(32, "little"))
    seed = h.digest()
    ls: list[G1] = []
    rs: list[G1] = []
    combiners: list[int] = []
    for i, (v, pub) in enumerate(checks):
        li, ri = v.final_check_points(pub)
        if i == 0:
            r_i = 1
        else:
            r_i = (
                int.from_bytes(
                    hashlib.sha3_256(seed + i.to_bytes(4, "little")).digest(),
                    "little",
                )
                % Q
            )
        ls.append(li)
        rs.append(ri)
        combiners.append(r_i)
    lhs = msm_host.multiexp(ls, combiners)
    rhs = msm_host.multiexp(rs, combiners)
    f12 = multi_miller_loop([(lhs, x_2), (-rhs, G2.generator())])
    return final_exponentiation(f12).is_one()
