"""Optimal ate pairing on BLS12-381 — host-side exact.

Reference parity: lib/bls12_381/src/pairings.rs (miller loop
pairings.rs:668-694, line evaluation :696-770, G2Prepared :498-552,
final exponentiation :48-177). Implemented from the optimal-ate
algorithm for BLS curves — not a port: we run affine G2 steps whose
slope/intercept chain depends only on Q, so the whole chain (incl. its
~70 Fp2 inversions) is precomputed ONCE per Q (``G2Prepared``) and
cached; the per-pairing Miller loop is then inversion-free — each line
is two Fp2 scalings of the stored coefficients plus one sparse
``mul_by_014`` fold (fp12.rs:116-129). ``multi_miller_loop`` shares the
f^2 squarings across all pairs.

The pairing sits on the verifier path only (2 pairings per verify,
verifier.rs:187-191) so a host implementation is appropriate; the MSM /
NTT throughput paths are the device components.
"""
from __future__ import annotations

from ..fields import fq
from ..fields.tower import Fp2, Fp6, Fp12
from .g1 import G1
from .g2 import G2

P = fq.P

# BLS parameter: x = -0xd201000000010000 (lib/bls12_381/src/lib.rs:72-74).
BLS_X = 0xD201000000010000
BLS_X_IS_NEGATIVE = True

_BITS = bin(BLS_X)[2:]


class G2Prepared:
    """Precomputed Miller-loop line chain for a fixed Q (pairings.rs:498-552).

    Affine doubling/addition steps on the twist; each step stores
    (lam, c = lam*x_T - y_T). The untwisted line through T evaluated at
    P = (xp, yp) is then  c - (lam*xp) w^2 + yp w^3  — independent of P
    until evaluation, so preparation amortizes all slope inversions.
    Step order follows the bits of |x| MSB->LSB: one doubling entry per
    bit after the first, plus one addition entry after each set bit.
    """

    __slots__ = ("is_identity", "coeffs")

    def __init__(self, q: G2):
        if q.is_identity():
            self.is_identity = True
            self.coeffs: list[tuple[Fp2, Fp2]] = []
            return
        self.is_identity = False
        xq, yq = q.to_affine()
        tx, ty = xq, yq
        coeffs = []
        for bit in _BITS[1:]:
            # double step: lam = 3 tx^2 / (2 ty)
            lam = tx.square().mul_fp(3) * (ty + ty).inv()
            coeffs.append((lam, lam * tx - ty))
            x3 = lam.square() - tx - tx
            ty = lam * (tx - x3) - ty
            tx = x3
            if bit == "1":
                # add step: lam = (ty - yq) / (tx - xq)
                lam = (ty - yq) * (tx - xq).inv()
                coeffs.append((lam, lam * tx - ty))
                x3 = lam.square() - tx - xq
                ty = lam * (tx - x3) - ty
                tx = x3
        self.coeffs = coeffs


_PREPARED_CACHE: dict[tuple, G2Prepared] = {}


def prepare(q: G2) -> G2Prepared:
    """Cached G2Prepared for q (the verifier reuses x_2 and the generator)."""
    if q.is_identity():
        key = None
    else:
        xq, yq = q.to_affine()
        key = (xq.c0, xq.c1, yq.c0, yq.c1)
    prep = _PREPARED_CACHE.get(key)
    if prep is None:
        if len(_PREPARED_CACHE) > 64:
            _PREPARED_CACHE.clear()
        prep = _PREPARED_CACHE[key] = G2Prepared(q)
    return prep


def multi_miller_loop(pairs: list) -> Fp12:
    """Product of Miller loops with shared squarings (pairings.rs:554-605).

    ``pairs`` entries are (G1, G2) or (G1, G2Prepared).
    """
    evals = []  # (xp_fp2-scaled later, yp, coeffs)
    for p, q in pairs:
        prep = q if isinstance(q, G2Prepared) else prepare(q)
        if p.is_identity() or prep.is_identity:
            continue
        xp, yp = p.to_affine()
        evals.append((xp, Fp2(yp, 0), prep.coeffs))
    f = Fp12.one()
    if not evals:
        return f
    idx = 0
    for i, bit in enumerate(_BITS[1:]):
        if i:
            f = f.square()
        for xp, yp2, coeffs in evals:
            lam, c = coeffs[idx]
            f = f.mul_by_014(c, -lam.mul_fp(xp), yp2)
        idx += 1
        if bit == "1":
            for xp, yp2, coeffs in evals:
                lam, c = coeffs[idx]
                f = f.mul_by_014(c, -lam.mul_fp(xp), yp2)
            idx += 1
    if BLS_X_IS_NEGATIVE:
        # f^(-|x|) == conj(f^|x|) up to factors killed by the final exponentiation
        f = f.conjugate()
    return f


def miller_loop(p: G1, q: G2) -> Fp12:
    """Miller loop for e(p, q); returns f before final exponentiation."""
    return multi_miller_loop([(p, q)])


def _cyclotomic_exp_abs_x(f: Fp12) -> Fp12:
    """f^|x| by square-and-multiply with Granger-Scott cyclotomic
    squarings (f is in the cyclotomic subgroup after the easy part).
    |x| = 2^63 + 2^62 + 2^60 + 2^57 + 2^48 + 2^16 has only 6 set bits,
    so the cost is ~63 cyclotomic squarings + 5 dense multiplies."""
    result = None
    bit = 1 << (BLS_X.bit_length() - 1)
    while bit:
        if result is not None:
            result = result.cyclotomic_square()
        if BLS_X & bit:
            result = f if result is None else result * f
        bit >>= 1
    return result


def final_exponentiation(f: Fp12) -> Fp12:
    """f^((p^12 - 1) / r)."""
    # Easy part: f^((p^6 - 1)(p^2 + 1))
    f = f.conjugate() * f.inv()
    f = f.frobenius().frobenius() * f
    # Hard part: f^((p^4 - p^2 + 1) / r) via the BLS12 lattice decomposition
    #   (x-1)^2 * (x + p) * (x^2 + p^2 - 1) + 3
    # evaluated with Frobenius maps and |x|-exponentiations (x is negative).
    # After the easy part f is in the cyclotomic subgroup, so f^(-1) = conj(f).
    def exp_x(g: Fp12) -> Fp12:
        # g^x with x negative: g^|x| then conjugate (cyclotomic inverse).
        return _cyclotomic_exp_abs_x(g).conjugate()

    # t = f^((x-1)^2) = (f^x * f^-1)^x * (f^x * f^-1)^-1
    t0 = exp_x(f) * f.conjugate()
    t1 = exp_x(t0) * t0.conjugate()
    # t2 = t1^(x + p) = t1^x * frob(t1)
    t2 = exp_x(t1) * t1.frobenius()
    # t3 = t2^(x^2 + p^2 - 1) = (t2^x)^x * frob2(t2) * t2^-1
    t3 = exp_x(exp_x(t2)) * t2.frobenius().frobenius() * t2.conjugate()
    # result = t3 * f^3
    return t3 * f.square() * f


def final_exponentiation_slow(f: Fp12) -> Fp12:
    """Integer-exponent hard part; oracle for the fast chain (tests only).

    Note: like the reference (pairings.rs:144-170, verified symbolically),
    the hard part computes f^(3*(p^4-p^2+1)/r) — the standard
    lattice-reduced variant; z -> z^3 is an automorphism of the r-order
    subgroup so the pairing remains bilinear and non-degenerate, and this
    matches the reference's Gt values exactly.
    """
    f = f.conjugate() * f.inv()
    f = f.frobenius().frobenius() * f
    from ..fields.fr import Q as R

    h = 3 * (P**4 - P**2 + 1) // R
    return f.pow(h)


def pairing(p: G1, q: G2) -> Fp12:
    """e(p, q) — matches pairings.rs:607-653 semantics."""
    return final_exponentiation(miller_loop(p, q))
