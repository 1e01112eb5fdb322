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

Fused round expressions (csrc/field.cu): what ``jax.jit`` compiled into one
executable in the reference is one kernel here, every intermediate in
registers, each row read once: ``round3_combine`` (``bpt_round3_combine``,
JAX ``_round3_combine_rows`` :75) and ``grand_product_fg``
(``bpt_grand_product_fg``, the f and g of JAX
``tpu_engine._grand_product_full`` :85). Their plain versions are the
unfused expressions over ``limbs``.
"""
from __future__ import annotations

import functools

import torch

from ..fields import fr
from ..protocol.poly import Basis

from . import kernels, limbs
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


def scalars(values, device) -> torch.Tensor:
    """(16, k) Montgomery forms of k host scalars, one transfer."""
    return FR.pack_raw([v % Q * FR.R % Q for v in values], device)


def _ops(plain: bool):
    """(mul, add, sub): the dispatching wrappers, or the plain versions
    whatever the device."""
    if plain:
        return tuple((lambda a, b, f=f: f(FR, a, b).to(torch.int32))
                     for f in (limbs._mont_mul_plain, limbs._add_plain, limbs._sub_plain))
    return _mm, _add, _sub


def _grand_product_fg_plain(a, b, c, s1, s2, s3, roots, sc, plain=True):
    mm, add, _ = _ops(plain)
    beta, gamma, k1, k2 = (sc[:, i : i + 1] for i in range(4))

    def rlc(x, y):
        return add(add(x, mm(beta, y)), gamma)

    f = mm(mm(rlc(a, roots), rlc(b, mm(roots, k1))), rlc(c, mm(roots, k2)))
    g = mm(mm(rlc(a, s1), rlc(b, s2)), rlc(c, s3))
    return f, g


def grand_product_fg(a, b, c, s1, s2, s3, roots, beta: int, gamma: int, k1: int, k2: int,
                     plain: bool = False):
    """Round 2's two products per row, all (16, n) Montgomery:
    f = rlc(a, w) rlc(b, k1 w) rlc(c, k2 w), g = rlc(a, s1) rlc(b, s2)
    rlc(c, s3) with rlc(x, y) = x + beta y + gamma. On CUDA tensors one
    launch, 7 rows read and 2 written (bound: bytes), where the unfused
    expression is 18 launches."""
    rows = (a, b, c, s1, s2, s3, roots)
    sc = scalars((beta, gamma, k1, k2), a.device)
    if plain or kernels.on_cpu(*rows):
        return _grand_product_fg_plain(*rows, sc, plain)
    dev = kernels.check_cuda(*rows)
    n = a.shape[-1]
    if any(r.shape != (16, n) for r in rows):
        raise ValueError("grand_product_fg: rows must all be (16, n)")
    rows = [r.contiguous() for r in rows]
    f, g = torch.empty_like(rows[0]), torch.empty_like(rows[0])
    kernels.launch("bpt_grand_product_fg", dev, *(kernels.ptr(r) for r in rows), kernels.ptr(sc),
                   kernels.ptr(f), kernels.ptr(g), n)
    grand_product_fg.launches += 1
    return f, g


def _round3_combine_plain(live, fixed, zh_inv, dpow, sc, shift, zw=None, plain=True):
    mm, add, sub = _ops(plain)
    aE, bE, cE, zE, piE = live.unbind(1)
    s1E, s2E, s3E, qlE, qrE, qmE, qoE, qcE, l1E = fixed.unbind(1)
    beta, gamma, alpha, alpha2, k1, k2 = (sc[:, i : i + 1] for i in range(6))
    zwE = torch.roll(zE if zw is None else zw, -shift, dims=-1)

    def rlc(x, y):
        return add(add(x, mm(beta, y)), gamma)

    gate = add(
        add(add(mm(aE, qlE), mm(bE, qrE)), mm(mm(aE, bE), qmE)),
        add(add(mm(cE, qoE), piE), qcE),
    )
    perm = sub(
        mm(mm(mm(rlc(aE, dpow), rlc(bE, mm(k1, dpow))), rlc(cE, mm(k2, dpow))), zE),
        mm(mm(mm(rlc(aE, s1E), rlc(bE, s2E)), rlc(cE, s3E)), zwE),
    )
    first = mm(sub(zE, FR.one(live.device)), l1E)
    allE = add(gate, add(mm(alpha, perm), mm(alpha2, first)))
    return mm(allE, zh_inv)


def round3_combine(live, fixed, zh_inv, dpow, sc, shift: int, zw=None, plain: bool = False):
    """Round 3's pointwise combination on the coset, (16, m) Montgomery:
    (gate + alpha perm + alpha^2 first-row) / Z_H. ``live`` (16, 5, m): the
    evaluations of a, b, c, z, pi; ``fixed`` (16, 9, m): s1, s2, s3, ql, qr,
    qm, qo, qc, l1; ``sc`` (16, 6): beta, gamma, alpha, alpha^2, k1, k2;
    z(w x) is read ``shift`` lanes ahead (wrapping) in ``zw`` (16, m) where
    it is given, else in live's z row (one device; a shard of the mesh may
    need another shard's z). On CUDA tensors one launch, 16 rows read (17
    with ``zw``) and one written (bound: bytes), where the unfused
    expression is about 45 launches and a rolled copy of z. ``launches``
    counts the launches without ``zw``, ``launches_zw`` those with it."""
    ops = (live, fixed, zh_inv, dpow, sc) + (() if zw is None else (zw,))
    if plain or kernels.on_cpu(*ops):
        return _round3_combine_plain(live, fixed, zh_inv, dpow, sc, shift, zw, plain)
    dev = kernels.check_cuda(*ops)
    m = live.shape[-1]
    if (live.shape, fixed.shape, zh_inv.shape, dpow.shape, sc.shape) != (
            (16, 5, m), (16, 9, m), (16, m), (16, m), (16, 6)) or (zw is not None and zw.shape != (16, m)):
        raise ValueError("round3_combine: bad operand shapes")
    live, fixed, zh_inv, dpow, sc = (t.contiguous() for t in ops[:5])
    zw = None if zw is None else zw.contiguous()
    out = torch.empty((16, m), dtype=torch.int32, device=dev)
    kernels.launch("bpt_round3_combine", dev, kernels.ptr(live), kernels.ptr(fixed), kernels.ptr(zh_inv),
                   kernels.ptr(dpow), kernels.ptr(sc), None if zw is None else kernels.ptr(zw),
                   kernels.ptr(out), m, shift % m)
    if zw is None:
        round3_combine.launches += 1
    else:
        round3_combine.launches_zw += 1
    return out


grand_product_fg.launches = 0
round3_combine.launches = 0
round3_combine.launches_zw = 0


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
    live = _coset_ntt([a_c, b_c, c_c, z_c, pi_c], m, gpow)
    # z(w x) on the coset: w = W^(m/n), so its evaluations are z's shifted
    # left by m/n = 4 positions (the NTT output is in natural order)
    sc = scalars((beta, gamma, alpha, alpha * alpha, k1, k2), dev)
    tE = round3_combine(live, fixed[1], zh_inv, dpow, sc, m // n)
    t = _mm(ntt_device(tE, inverse=True), ginvpow)
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
