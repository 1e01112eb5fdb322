"""The plain reference that judges each proof the benchmark samples.

It knows the SRS's secret tau, which the configuration states (a toy
trusted setup, as baby-plonk-rust's setup.rs takes tau in), so every KZG
commitment [p(tau)] G is one scalar times the generator, and p(tau) is a
sum over the circuit's rows in the Lagrange basis. From the constraint
lines, the witness, the 11 blinding scalars and the public values alone it
works out again what the prover should have sent, and compares:

- the commitments a, b, c, z, exactly (their blinding included);
- [t_lo] + tau^n [t_mid] + tau^2n [t_hi] against t(tau) G, where
  t(tau) = (gates + alpha perm + alpha^2 (z - 1) L1)(tau) / Z_H(tau);
- the six evaluations a, b, c, s1, s2 at zeta and z at zeta omega, exactly;
- W_zeta against what the linearization at zeta gives with the proof's own
  t pieces, and W_zeta_omega against (z(tau) - z(zeta omega)) / (tau - zeta
  omega) G, exactly;
- where asked (``split``), [t_lo], [t_mid] and [t_hi] one by one, with the
  blinding scalars b10 and b11 that split t: t's values on a coset of 4n
  points give each piece at tau. The two linear checks above cannot see
  b10 and b11 (they cancel in every sum t_lo + x^n t_mid + x^2n t_hi), and
  the split costs four transforms of 4n points a proof, so a run asks for
  it on few proofs and at small n only.

The challenges come from replaying the transcript over the proof's bytes.

Nothing here imports the program or torch. The proof-independent part
(parsing the constraint lines, the permutation, the selectors and sigmas at
tau, the Lagrange weights at tau and, for the split, the selectors' and
sigmas' values on the coset) is kept in a cache directory by a key of
the lines, n, tau and this package's sources, so that only the first run in
a checkout pays it.
"""
from __future__ import annotations

import hashlib
import json
import os
from itertools import accumulate

import numpy as np

from . import assembly, fr
from . import ntt as nt
from .g1 import G1
from .transcript import PlonkTranscript

Q = fr.Q
K1, K2 = 2, 3
POINTS = ("a_1", "b_1", "c_1", "z_1", "t_lo_1", "t_mid_1", "t_hi_1", "w_zeta_1", "w_zeta_omega_1")
SCALARS = ("a_bar", "b_bar", "c_bar", "s1_bar", "s2_bar", "z_omega_bar")
PROOF_BYTES = 48 * len(POINTS) + 32 * len(SCALARS)
#: what ``check`` compares in one proof: 4 commitments, the t sum at tau,
#: 6 evaluations, 2 openings, and with ``split`` the three t pieces
ELEMENTS = ("a_1", "b_1", "c_1", "z_1", "t_sum") + SCALARS + ("w_zeta_1", "w_zeta_omega_1", "t_lo_1", "t_mid_1",
                                                              "t_hi_1")
#: the coset of 4n points on which the split check works out t: GENERATOR w^j
COSET = fr.GENERATOR


def _sources_digest() -> str:
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(here)):
        if name.endswith(".py"):
            with open(os.path.join(here, name), "rb") as f:
                h.update(name.encode() + f.read())
    return h.hexdigest()


def lagrange_weights(x: int, roots: list[int]) -> list[int]:
    """d_i = w^i / (x - w^i), so that p(x) = (x^n - 1) / n * sum_i p_i d_i
    for p given by its values p_i at the n-th roots w^i (one batch inversion)."""
    diffs = [(x - r) % Q for r in roots]
    if 0 in diffs:
        raise ZeroDivisionError("the point lies in the domain")
    prefix = list(accumulate(diffs, _mulmod, initial=1))
    inv = list(accumulate(reversed(diffs), _mulmod, initial=fr.inv(prefix[-1])))
    inv.reverse()  # inv[i + 1] = 1 / (diffs_0 .. diffs_i)
    return [p * q % Q * r % Q for p, q, r in zip(prefix, inv[1:], roots)]


def _mulmod(x: int, y: int) -> int:
    return x * y % Q


def dot(values, weights) -> int:
    return sum(map(int.__mul__, values, weights)) % Q


class Prepared:
    """The circuit as the reference derives it: per row the variable of
    each wire (L, R, O), the public variables, the three sigma columns, the
    selectors and sigmas at tau, and the Lagrange weights at tau."""

    def __init__(self, n, tau, wires, public, sigma, q_tau, s_tau, d_tau, selectors):
        self.n, self.tau = n, tau % Q
        self.wires, self.public, self.sigma = wires, public, sigma
        self.q_tau, self.s_tau, self.d_tau = q_tau, s_tau, d_tau
        #: the columns ql, qr, qm, qo, qc, each of n
        self.selectors = selectors
        self.roots = fr.roots_of_unity(n)
        self.omega = fr.root_of_unity(n)
        #: the cache directory this was read from or written to, if any
        self.path = None
        self._coset = None

    def coset(self) -> list:
        """The selectors and sigmas (ql, qr, qm, qo, qc, s1, s2, s3) at the
        4n points COSET w^j of the (4n)-th roots w; kept beside the cache."""
        if self._coset is None:
            n, path = self.n, self.path and os.path.join(self.path, "coset.bin")
            if path and os.path.isfile(path):
                with open(path, "rb") as f:
                    data = memoryview(f.read())
                flat = [int.from_bytes(data[i : i + 32], "little") for i in range(0, len(data), 32)]
                self._coset = [nt.ints(flat[k * 4 * n : (k + 1) * 4 * n]) for k in range(8)]
            else:
                if self.selectors is None:
                    raise ValueError("the coset values need the selectors: compute the circuit anew")
                self._coset = [nt.coset_values(col, 4, COSET) for col in (*self.selectors, *self.sigma)]
                if path:
                    with open(path + ".tmp", "wb") as f:
                        f.write(b"".join(int(v).to_bytes(32, "little") for col in self._coset for v in col))
                    os.replace(path + ".tmp", path)
        return self._coset

    @staticmethod
    def compute(lines: list[str], n: int, tau: int) -> "Prepared":
        if len(lines) > n:
            raise ValueError(f"{len(lines)} constraints exceed group order {n}")
        rows = [assembly.row(line) for line in lines]
        public = []
        for i, (_, _, name) in enumerate(rows):
            if name is None:
                break
            public.append(name)
        if any(name is not None for _, _, name in rows[len(public):]):
            raise ValueError("Public var declarations must be at the top")
        wires = tuple([r[0][k] for r in rows] for k in range(3))
        roots = fr.roots_of_unity(n)
        # the copy-constraint cycles in the order of baby-plonk-rust
        # program.rs (as baby_plonk_tpu_torch/protocol/program.py's
        # make_s_polynomials at commit 7bdee1a): each variable's cells, row
        # by row, then the unused cells as one cycle; s[next cell] = label(cell)
        uses: dict = {}
        for row, (wr, _, _) in enumerate(rows):
            for column, var in enumerate(wr):
                uses.setdefault(var, []).append((column, row))
        for row in range(len(rows), n):
            for column in range(3):
                uses.setdefault(None, []).append((column, row))
        sigma = [list(roots), [r * 2 % Q for r in roots], [0] * n]
        for cells in uses.values():
            m = len(cells)
            for i, (column, row) in enumerate(cells):
                nc, nr = cells[(i + 1) % m]
                sigma[nc][nr] = roots[row] * (column + 1) % Q
        tau %= Q
        d_tau = lagrange_weights(tau, roots)
        scale = (pow(tau, n, Q) - 1) * fr.inv(n) % Q
        selectors = [[r[1][k] for r in rows] + [0] * (n - len(rows)) for k in range(5)]
        q_tau = [dot(q, d_tau) * scale % Q for q in selectors]
        s_tau = [dot(s, d_tau) * scale % Q for s in sigma]
        return Prepared(n, tau, wires, public, sigma, q_tau, s_tau, d_tau, selectors)

    # -- the cache ----------------------------------------------------------

    @staticmethod
    def key(lines: list[str], n: int, tau: int) -> str:
        h = hashlib.sha256(f"{n} {tau % Q} {_sources_digest()}\n".encode())
        h.update("\n".join(lines).encode())
        return h.hexdigest()[:24]

    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        with open(os.path.join(tmp, "wires.txt"), "w") as f:
            f.write("\n".join("" if v is None else v for col in self.wires for v in col))
        with open(os.path.join(tmp, "ints.bin"), "wb") as f:
            for col in (*self.sigma, self.d_tau):
                f.write(b"".join(v.to_bytes(32, "little") for v in col))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"n": self.n, "tau": hex(self.tau), "rows": len(self.wires[0]), "public": self.public,
                       "q_tau": [hex(v) for v in self.q_tau], "s_tau": [hex(v) for v in self.s_tau]}, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Prepared":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        n, m = meta["n"], meta["rows"]
        with open(os.path.join(path, "wires.txt")) as f:
            flat = [v or None for v in f.read().split("\n")] if m else []
        wires = tuple(flat[k * m : (k + 1) * m] for k in range(3))
        with open(os.path.join(path, "ints.bin"), "rb") as f:
            data = memoryview(f.read())
        ints = [int.from_bytes(data[i : i + 32], "little") for i in range(0, 4 * 32 * n, 32)]
        sigma = [ints[k * n : (k + 1) * n] for k in range(3)]
        prep = Prepared(n, int(meta["tau"], 16), wires, meta["public"], sigma,
                        [int(v, 16) for v in meta["q_tau"]], [int(v, 16) for v in meta["s_tau"]], ints[3 * n :], None)
        prep.path = path
        return prep

    @staticmethod
    def cached(lines: list[str], n: int, tau: int, cache_dir: str, coset: bool = False) -> "Prepared":
        """From the cache directory where it holds this circuit (with its
        ``coset`` values, if asked), else computed and written there."""
        path = os.path.join(cache_dir, Prepared.key(lines, n, tau))
        if os.path.isdir(path) and (not coset or os.path.isfile(os.path.join(path, "coset.bin"))):
            return Prepared.load(path)
        prep = Prepared.compute(lines, n, tau)
        if not os.path.isdir(path):
            os.makedirs(cache_dir, exist_ok=True)
            prep.save(path)
        prep.path = path
        if coset:
            prep.coset()
        return prep


def _blind(coeffs: list[int], x: int, zh: int) -> int:
    """(c_0 + c_1 x + ...) (x^n - 1) at x, the blinding term of a wire or z."""
    return sum(c * pow(x, k, Q) for k, c in enumerate(coeffs)) * zh % Q


def t_pieces(prep: Prepared, cols: list, z_values: list, b: list[int], pub: list[int], beta: int, gamma: int,
             alpha: int) -> tuple[int, int, int]:
    """t_lo, t_mid and t_hi at tau before b10 and b11: the coefficients
    [0, n), [n, 2n) and [2n, 4n) of t. From t's values t_j at the M = 4n
    points x_j = COSET w^j of the M-th roots w, t_i = (1/M) sum_j t_j x_j^-i,
    so the piece from kn of length L is (1/M) sum_j t_j x_j^-kn (1 - (tau /
    x_j)^L) / (1 - tau / x_j). x_j^n takes four values, by j mod 4."""
    n, tau = prep.n, prep.tau
    m = 4 * n
    w = fr.root_of_unity(m)
    x = nt.ints(nt.powers(w, m, COSET))
    xn = [pow(COSET, n, Q) * pow(w, n * c, Q) % Q for c in range(4)]  # x_j^n for j = c mod 4
    zh = nt.ints(v - 1 for v in xn * n)
    blind = lambda coeffs: sum(c * x ** k for k, c in enumerate(coeffs)) % Q * zh % Q  # noqa: E731
    a, bb, c = (nt.coset_values(col, 4, COSET) + blind([b[2 * k + 1], b[2 * k]]) for k, col in enumerate(cols))
    z = nt.coset_values(z_values, 4, COSET) + blind([b[8], b[7], b[6]])
    z_w = np.roll(z, -4)  # z(w_n x_j) = z(x_{j+4})
    ql, qr, qm, qo, qc, s1, s2, s3 = prep.coset()

    def lagrange(k: int) -> np.ndarray:  # L_k(x_j) = w_n^k (x_j^n - 1) / (n (x_j - w_n^k))
        r = prep.roots[k]
        return nt.batch_inv((x - r) % Q) * (r * fr.inv(n) % Q) % Q * zh % Q

    pi = sum(((-v) % Q * lagrange(k) for k, v in enumerate(pub)), nt.ints([0] * m))
    gate = (a * bb % Q * qm + a * ql + bb * qr + c * qo + pi + qc) % Q
    bx = beta * x % Q
    perm = ((a + bx + gamma) * (bb + K1 * bx + gamma) % Q * (c + K2 * bx + gamma) % Q * z
            - (a + beta * s1 + gamma) * (bb + beta * s2 + gamma) % Q * (c + beta * s3 + gamma) % Q * z_w) % Q
    num = (gate + alpha * perm + alpha * alpha % Q * ((z - 1) * lagrange(0) % Q)) % Q
    weights = nt.batch_inv((x - tau) % Q) * x % Q * fr.inv(m) % Q  # x_j / (M (x_j - tau))
    sums = [int(np.sum(num[k::4] * weights[k::4] % Q)) * fr.inv(xn[k] - 1) % Q for k in range(4)]  # sum of t_j u_j
    y = [fr.inv(v) for v in xn]  # x_j^-n
    tau_n = pow(tau, n, Q)
    lo = sum(sc * (1 - tau_n * yc) for sc, yc in zip(sums, y)) % Q
    mid = sum(sc * yc % Q * (1 - tau_n * yc) for sc, yc in zip(sums, y)) % Q
    hi = sum(sc * yc % Q * yc % Q * (1 - tau_n * tau_n % Q * yc % Q * yc) for sc, yc in zip(sums, y)) % Q
    return lo, mid, hi


def check(prep: Prepared, proof: bytes, witness: dict, blinding: list[int], public_values: list[int],
          split: bool = False) -> list[str]:
    """The elements of ``proof`` (names from ``ELEMENTS``) that differ from
    what the reference works out; empty for a proof that is right. A proof
    of the wrong length or with an undecodable element differs in all.
    ``split`` also checks t's three pieces one by one."""
    if len(proof) != PROOF_BYTES or len(blinding) != 11:
        return list(ELEMENTS)
    pts = {name: proof[48 * i : 48 * (i + 1)] for i, name in enumerate(POINTS)}
    off = 48 * len(POINTS)
    ev = [fr.from_bytes(proof[off + 32 * i : off + 32 * (i + 1)]) for i in range(len(SCALARS))]
    if any(v is None for v in ev):
        return list(ELEMENTS)
    n, tau, roots, omega = prep.n, prep.tau, prep.roots, prep.omega
    b = [v % Q for v in blinding]
    pub = [witness[name] % Q for name in prep.public]
    if pub != [v % Q for v in public_values]:
        raise ValueError("the witness's public values are not the request's")

    tr = PlonkTranscript(b"plonk")
    beta, gamma = tr.round_1(pts["a_1"], pts["b_1"], pts["c_1"])
    alpha = tr.round_2(pts["z_1"])
    zeta = tr.round_3(pts["t_lo_1"], pts["t_mid_1"], pts["t_hi_1"])
    nu = tr.round_4(ev)

    m = len(prep.wires[0])
    cols = [[0 if v is None else witness[v] % Q for v in col] + [0] * (n - m) for col in prep.wires]
    a, bb, c = cols
    s1, s2, s3 = prep.sigma

    # the grand product: z_0 = 1, z_{i+1} = z_i f_i / g_i, so z_i = F_i / G_i
    # with F_i, G_i the products of f_j, g_j over j < i
    bws = [beta * r % Q for r in roots]
    f = [(x + t + gamma) * (y + K1 * t + gamma) % Q * (u + K2 * t + gamma) % Q for x, y, u, t in zip(a, bb, c, bws)]
    g = [(x + beta * p + gamma) * (y + beta * q + gamma) % Q * (u + beta * r + gamma) % Q
         for x, y, u, p, q, r in zip(a, bb, c, s1, s2, s3)]
    F = list(accumulate(f, _mulmod, initial=1))
    G_ = list(accumulate(g, _mulmod, initial=1))
    inv_g = list(accumulate(reversed(g), _mulmod, initial=fr.inv(G_[n])))
    inv_g.reverse()  # inv_g[i] = 1 / G_i
    z = list(map(_mulmod, F, inv_g))
    zn = z[n]
    z_shift = z[1:]  # z_{i+1}, with z_n, which closes to 1 for a satisfied circuit

    inv_n = fr.inv(n)
    zh_tau = (pow(tau, n, Q) - 1) % Q
    sc_tau = zh_tau * inv_n % Q
    d_tau = prep.d_tau
    a_t = (_blind([b[1], b[0]], tau, zh_tau) + sc_tau * dot(a, d_tau)) % Q
    b_t = (_blind([b[3], b[2]], tau, zh_tau) + sc_tau * dot(bb, d_tau)) % Q
    c_t = (_blind([b[5], b[4]], tau, zh_tau) + sc_tau * dot(c, d_tau)) % Q
    zb = [b[8], b[7], b[6]]
    z_t = (_blind(zb, tau, zh_tau) + sc_tau * dot(z[:n], d_tau)) % Q
    z_wt = (_blind(zb, omega * tau % Q, zh_tau) + sc_tau * dot(z_shift, d_tau)) % Q

    ql, qr, qm, qo, qc = prep.q_tau
    S1, S2, S3 = prep.s_tau
    l1_t = sc_tau * fr.inv(tau - 1) % Q
    pi_t = -sum(v * sc_tau * roots[k] % Q * fr.inv(tau - roots[k]) for k, v in enumerate(pub)) % Q
    gate = (a_t * ql + b_t * qr + a_t * b_t % Q * qm + c_t * qo + pi_t + qc) % Q
    perm = ((a_t + beta * tau + gamma) * (b_t + beta * K1 * tau + gamma) % Q * (c_t + beta * K2 * tau + gamma) % Q * z_t
            - (a_t + beta * S1 + gamma) * (b_t + beta * S2 + gamma) % Q * (c_t + beta * S3 + gamma) % Q * z_wt) % Q
    t_t = (gate + alpha * perm + alpha * alpha % Q * (z_t - 1) % Q * l1_t) * fr.inv(zh_tau) % Q

    # evaluations at zeta
    d_z = lagrange_weights(zeta, roots)
    zeta_n = pow(zeta, n, Q)
    zh_z = (zeta_n - 1) % Q
    sc_z = zh_z * inv_n % Q
    want_ev = [
        (_blind([b[1], b[0]], zeta, zh_z) + sc_z * dot(a, d_z)) % Q,
        (_blind([b[3], b[2]], zeta, zh_z) + sc_z * dot(bb, d_z)) % Q,
        (_blind([b[5], b[4]], zeta, zh_z) + sc_z * dot(c, d_z)) % Q,
        sc_z * dot(s1, d_z) % Q,
        sc_z * dot(s2, d_z) % Q,
        (_blind(zb, zeta * omega % Q, zh_z) + sc_z * dot(z_shift, d_z)) % Q,
    ]

    bad = []
    G = G1.generator()
    for name, v in (("a_1", a_t), ("b_1", b_t), ("c_1", c_t), ("z_1", z_t)):
        if (G * v).to_compressed() != pts[name]:
            bad.append(name)
    t_pts = [G1.from_compressed(pts[k]) for k in ("t_lo_1", "t_mid_1", "t_hi_1")]
    tau_n = pow(tau, n, Q)
    if None in t_pts or t_pts[0] + t_pts[1] * tau_n + t_pts[2] * (tau_n * tau_n % Q) != G * t_t:
        bad.append("t_sum")
    bad += [name for name, got, want in zip(SCALARS, ev, want_ev) if got != want]

    # the openings, from the proof's own evaluations (the prover's r uses them)
    a_e, b_e, c_e, s1_e, s2_e, zw_e = ev
    l1_z = sc_z * fr.inv(zeta - 1) % Q
    pi_z = -sum(v * sc_z * roots[k] % Q * fr.inv(zeta - roots[k]) for k, v in enumerate(pub)) % Q
    v2 = (a_e + zeta * beta + gamma) * (b_e + zeta * beta * K1 + gamma) % Q * (c_e + zeta * beta * K2 + gamma) % Q
    w3 = (a_e + s1_e * beta + gamma) * (b_e + s2_e * beta + gamma) % Q * zw_e % Q
    alpha2 = alpha * alpha % Q
    nus = [pow(nu, i, Q) for i in range(6)]
    scalar = (a_e * b_e % Q * qm + a_e * ql + b_e * qr + c_e * qo + qc
              + (alpha * v2 + alpha2 * l1_z) % Q * z_t - alpha * beta % Q * w3 % Q * S3
              + pi_z - alpha * w3 % Q * (c_e + gamma) - alpha2 * l1_z
              + nus[1] * (a_t - a_e) + nus[2] * (b_t - b_e) + nus[3] * (c_t - c_e)
              + nus[4] * (S1 - s1_e) + nus[5] * (S2 - s2_e)) % Q
    w_zeta = None
    if None not in t_pts:
        t_zeta = t_pts[0] + t_pts[1] * zeta_n + t_pts[2] * (zeta_n * zeta_n % Q)
        w_zeta = (G * scalar - t_zeta * zh_z) * fr.inv(tau - zeta)
    if w_zeta is None or w_zeta.to_compressed() != pts["w_zeta_1"]:
        bad.append("w_zeta_1")
    zeta_w = zeta * omega % Q
    if (G * ((z_t - zw_e) * fr.inv(tau - zeta_w) % Q)).to_compressed() != pts["w_zeta_omega_1"]:
        bad.append("w_zeta_omega_1")
    if split:
        pieces = t_pieces(prep, cols, z[:n], b, pub, beta, gamma, alpha)
        if (pieces[0] + tau_n * pieces[1] + tau_n * tau_n % Q * pieces[2] - t_t) % Q:
            raise AssertionError("the reference's t pieces do not sum to its t(tau)")
        want = (pieces[0] + b[9] * tau_n, pieces[1] - b[9] + b[10] * tau_n, pieces[2] - b[10])
        bad += [name for name, v in zip(("t_lo_1", "t_mid_1", "t_hi_1"), want)
                if (G * (v % Q)).to_compressed() != pts[name]]
    if zn != 1:
        raise ValueError("the witness does not satisfy the circuit: the grand product does not close")
    return bad
