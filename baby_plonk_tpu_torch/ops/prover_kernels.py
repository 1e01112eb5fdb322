"""Device pipelines of prover rounds 3 and 5 (counterpart of
``baby_plonk_tpu/ops/prover_kernels.py``).

Round 3 (``round3_quotient_device``, JAX :207): the 15 operand
polynomials are scaled onto the coset g<w_4n> and forward-NTT'd on the 4n
domain, the constraint combination (gate + alpha perm + alpha^2 first
row) is evaluated pointwise, divided pointwise by Z_H (four distinct
values on the coset), and one inverse NTT plus the coset unscale gives the
quotient t of degree 3n+5. This is the JAX package's split path (:238-282):
the nine proof-independent rows are transformed once per proving key and
cached on it, z(wx)'s evaluations are z's shifted by 4 positions. The
fused single-kernel path computes the same function and has no separate
counterpart.

Round 5 (``linear_combine_device``, JAX :324): sum_i c_i p_i + const as
one stacked multiply and a halving sum.
"""
from __future__ import annotations

import functools

import torch

from ..fields import fr
from ..protocol.poly import Basis

from . import limbs
from .dpoly import DPoly, _debug_asserts, pad_to, pow_table, scalar
from .limbs import FR
from .ntt import ntt_device

Q = fr.Q


def _mm(a, b):
    return limbs.mont_mul(FR, a, b)


def _add(a, b):
    return limbs.add_mod(FR, a, b)


def _sub(a, b):
    return limbs.sub_mod(FR, a, b)


@functools.lru_cache(maxsize=4)
def _round3_consts(m: int, device: str):
    """(zh_inv, gpow, ginvpow, dpow), each (16, m): 1/Z_H on the coset
    (Z_H(g w^j) = g^n w4^j - 1 with w4 = w^n of order 4), g^j, g^-j and the
    domain points g w^j."""
    n = m // 4
    g = fr.GENERATOR
    w = fr.root_of_unity(m)
    w4, gn = pow(w, n, Q), pow(g, n, Q)
    zh = [pow((gn * pow(w4, j, Q) - 1) % Q, Q - 2, Q) for j in range(4)]
    zh_inv = FR.pack_mont(zh, device).repeat(1, m // 4)
    gpow = pow_table(scalar(g, device), m)
    ginvpow = pow_table(scalar(pow(g, Q - 2, Q), device), m)
    dpow = _mm(pow_table(scalar(w, device), m), scalar(g, device))
    return zh_inv, gpow, ginvpow, dpow


def _coset_ntt(polys, m: int, gpow) -> torch.Tensor:
    """(16, r, m): forward NTTs of the coset-scaled, zero-padded polys."""
    stacked = torch.stack([pad_to(p.vals, m) for p in polys], dim=1)
    return ntt_device(_mm(stacked, gpow[:, None, :]))


def round3_quotient_device(
    a_c, b_c, c_c, z_c, zw_c, s1_c, s2_c, s3_c,
    ql_c, qr_c, qm_c, qo_c, qc_c, pi_c, l1_c,
    beta: int, gamma: int, alpha: int, k1: int, k2: int, n: int,
    pk_cache=None,
):
    """Inputs are monomial DPolys; returns the quotient t (3n+6 coefficients).
    ``pk_cache`` (the proving key) keeps the coset evaluations of the nine
    proof-independent rows in its ``coset_rows``."""
    m = 4 * n
    dev = a_c.vals.device
    zh_inv, gpow, ginvpow, dpow = _round3_consts(m, str(dev))
    fixed = pk_cache.coset_rows if pk_cache is not None else None
    if fixed is None or fixed[0] != (m, str(dev)):
        rows = _coset_ntt([s1_c, s2_c, s3_c, ql_c, qr_c, qm_c, qo_c, qc_c, l1_c], m, gpow)
        fixed = ((m, str(dev)), rows)
        if pk_cache is not None:
            pk_cache.coset_rows = fixed
    s1E, s2E, s3E, qlE, qrE, qmE, qoE, qcE, l1E = fixed[1].unbind(1)
    aE, bE, cE, zE, piE = _coset_ntt([a_c, b_c, c_c, z_c, pi_c], m, gpow).unbind(1)
    # z(w x) on the coset: w = W^(m/n), so its evaluations are z's shifted
    # left by m/n = 4 positions (the NTT output is in natural order)
    zwE = torch.roll(zE, -(m // n), dims=-1)

    beta_m, gamma_m = scalar(beta, dev), scalar(gamma, dev)

    def rlc(x, y):
        return _add(_add(x, _mm(beta_m, y)), gamma_m)

    gate = _add(
        _add(_add(_mm(aE, qlE), _mm(bE, qrE)), _mm(_mm(aE, bE), qmE)),
        _add(_add(_mm(cE, qoE), piE), qcE),
    )
    k1d, k2d = _mm(scalar(k1, dev), dpow), _mm(scalar(k2, dev), dpow)
    perm = _sub(
        _mm(_mm(_mm(rlc(aE, dpow), rlc(bE, k1d)), rlc(cE, k2d)), zE),
        _mm(_mm(_mm(rlc(aE, s1E), rlc(bE, s2E)), rlc(cE, s3E)), zwE),
    )
    first = _mm(_sub(zE, FR.one(dev)), l1E)
    allE = _add(gate, _add(_mm(scalar(alpha, dev), perm), _mm(scalar(alpha * alpha, dev), first)))
    t = _mm(ntt_device(_mm(allE, zh_inv), inverse=True), ginvpow)
    if _debug_asserts():
        # exact division <=> the 4n-interpolant has degree <= 3n + 5
        assert not bool(t[:, 3 * n + 6 :].any()), "constraint polynomial not divisible by Z_H"
    return DPoly(t[:, : 3 * n + 6].contiguous(), Basis.MONOMIAL)


def linear_combine_device(polys, coeffs: list[int], const: int) -> DPoly:
    """sum_i coeffs[i] * polys[i] + const (monomial DPolys)."""
    assert polys and len(polys) == len(coeffs)
    dev = polys[0].vals.device
    m = max(len(p) for p in polys)
    stacked = torch.stack([pad_to(p.vals, m) for p in polys], dim=1)  # (16, R, m)
    ck = FR.pack_mont([c % Q for c in coeffs], dev)[:, :, None]
    terms = _mm(stacked, ck)
    while terms.shape[1] > 1:
        half = terms.shape[1] // 2
        summed = _add(terms[:, :half], terms[:, half : 2 * half])
        terms = torch.cat([summed, terms[:, 2 * half :]], dim=1)
    out = terms[:, 0]
    out = torch.cat([_add(out[:, :1], scalar(const, dev)), out[:, 1:]], dim=-1)
    return DPoly(out, Basis.MONOMIAL)
