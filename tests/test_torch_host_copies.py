"""The port's own host layer (fields, curves, protocol, circuits, config)
against the JAX package's modules it was copied from, each package driven
with its own objects and compared at canonical values: Python ints, affine
coordinates, compressed bytes, proof bytes. Tolerance: exact."""
import importlib
import json
import os

import pytest

from baby_plonk_tpu_torch.curves.gt import _fp12_coeffs as port_fp12_coeffs
from baby_plonk_tpu.curves.gt import _fp12_coeffs as jax_fp12_coeffs

from torch_port_util import field_ints

_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
PKGS = ("baby_plonk_tpu", "baby_plonk_tpu_torch")


def both(module: str):
    """The module of that relative name in the JAX package and in the port."""
    return tuple(importlib.import_module(f"{p}.{module}") for p in PKGS)


def test_fields_fr_fq():
    for name, modulus_attr in (("fields.fr", "Q"), ("fields.fq", "P")):
        j, t = both(name)
        p = getattr(j, modulus_attr)
        assert getattr(t, modulus_attr) == p
        a, b = field_ints(201, p, 2)
        for op in ("add", "sub", "mul"):
            assert getattr(j, op)(a, b) == getattr(t, op)(a, b)
        assert j.neg(a) == t.neg(a) and j.inv(a) == t.inv(a)
        assert j.sqrt(a * a % p) == t.sqrt(a * a % p)
    jfr, tfr = both("fields.fr")
    assert jfr.roots_of_unity(16) == tfr.roots_of_unity(16)
    assert jfr.GENERATOR == tfr.GENERATOR
    vals = field_ints(202, jfr.Q, 5)
    assert jfr.batch_inv(vals) == tfr.batch_inv(vals)
    assert jfr.to_bytes(vals[0]) == tfr.to_bytes(vals[0])
    assert jfr.from_bytes_wide(bytes(range(64))) == tfr.from_bytes_wide(bytes(range(64)))


def test_fields_tower():
    j, t = both("fields.tower")
    p = both("fields.fq")[0].P
    c = field_ints(203, p, 12)

    def fp12(m):
        f2 = [m.Fp2(c[2 * i], c[2 * i + 1]) for i in range(6)]
        return m.Fp12(m.Fp6(*f2[:3]), m.Fp6(*f2[3:]))

    a, b = fp12(j), fp12(t)
    assert jax_fp12_coeffs(a * a) == port_fp12_coeffs(b * b)
    assert jax_fp12_coeffs(a.inv()) == port_fp12_coeffs(b.inv())
    assert jax_fp12_coeffs(a.frobenius()) == port_fp12_coeffs(b.frobenius())
    x, y = j.Fp2(c[0], c[1]), t.Fp2(c[0], c[1])
    sj, st = (x * x).sqrt(), (y * y).sqrt()
    assert (sj.c0, sj.c1) == (st.c0, st.c1)


def test_curves_g1_g2_scalar_multiples():
    k = field_ints(204, both("fields.fr")[0].Q, 1)[0]
    for name, cls in (("curves.g1", "G1"), ("curves.g2", "G2")):
        j, t = (getattr(m, cls) for m in both(name))
        pj, pt = j.generator() * k, t.generator() * k
        assert pj.to_compressed() == pt.to_compressed()
        assert pj.to_uncompressed() == pt.to_uncompressed()
        assert (pj + pj.double()).to_compressed() == (pt + pt.double()).to_compressed()
        assert t.from_compressed(pj.to_compressed()) == pt
        assert pt.is_on_curve() and pt.is_torsion_free()
        assert j.identity().to_compressed() == t.identity().to_compressed()
    jg1, tg1 = (m.G1 for m in both("curves.g1"))
    assert (jg1.generator() * k).to_affine() == (tg1.generator() * k).to_affine()


def test_curves_msm_host():
    (jm, tm), (jg, tg) = both("curves.msm_host"), both("curves.g1")
    ks = field_ints(205, both("fields.fr")[0].Q, 12)
    scalars = field_ints(206, both("fields.fr")[0].Q, 12)
    got = tm.msm([tg.G1.generator() * k for k in ks], scalars)
    want = jm.msm([jg.G1.generator() * k for k in ks], scalars)
    assert got.to_affine() == want.to_affine()


def test_curves_pairing_check():
    """e(a G1, b G2) == e(ab G1, G2) in both packages, with equal values."""
    a, b = 0x1234567, 0x89ABCDE
    outs = []
    for pkg in PKGS:
        g1 = importlib.import_module(f"{pkg}.curves.g1").G1
        g2 = importlib.import_module(f"{pkg}.curves.g2").G2
        pairing = importlib.import_module(f"{pkg}.curves.pairing")
        gt = importlib.import_module(f"{pkg}.curves.gt")
        lhs = pairing.pairing(g1.generator() * a, g2.generator() * b)
        rhs = pairing.pairing(g1.generator() * (a * b), g2.generator())
        assert lhs == rhs
        outs.append(gt._fp12_coeffs(lhs))
    assert outs[0] == outs[1]


def test_transcript_challenges():
    outs = []
    for pkg in PKGS:
        g1 = importlib.import_module(f"{pkg}.curves.g1").G1
        tr = importlib.import_module(f"{pkg}.protocol.transcript").PlonkTranscript(b"plonk")
        pts = [g1.generator() * k for k in (3, 5, 7, 11, 13, 17, 19, 23, 29)]
        beta, gamma = tr.round_1(*pts[:3])
        outs.append((beta, gamma, tr.round_2(pts[3]), tr.round_3(*pts[4:7]),
                     tr.round_4(1, 2, 3, 4, 5, 6), tr.round_5(*pts[7:9])))
    assert outs[0] == outs[1]


def test_keccak_native_and_python_agree():
    from baby_plonk_tpu_torch import native
    from baby_plonk_tpu_torch.utils import keccak

    jk = importlib.import_module("baby_plonk_tpu.utils.keccak")
    a, b = bytearray(range(200)), bytearray(range(200))
    keccak.keccak_f1600(a)
    jk.keccak_f1600(b)
    assert a == b
    if native.available():  # the pure-Python rounds, with the native path off
        c = bytearray(range(200))
        orig, native.available = native.available, lambda: False
        try:
            keccak.keccak_f1600(c)
        finally:
            native.available = orig
        assert c == a


def test_program_preprocessing_and_circuits():
    jc, tc = both("circuits")
    for name, arg in (("mul_chain", 8), ("fib_chain", 8), ("inner_product", [(2, 3), (5, 7)])):
        assert getattr(jc, name)(arg) == getattr(tc, name)(arg), name
    assert jc.poly_eval([3, 1, 4, 1], 5) == tc.poly_eval([3, 1, 4, 1], 5)
    constraints, _, _ = tc.mul_chain(8)
    polys = []
    for pkg in PKGS:
        program = importlib.import_module(f"{pkg}.protocol.program").Program.from_strs(constraints, 8)
        pk = program.common_preprocessed_input()
        polys.append([getattr(pk, k).values for k in ("ql", "qr", "qm", "qo", "qc", "s1", "s2", "s3")])
        polys[-1].append(program.get_public_assignment())
    assert polys[0] == polys[1]


def test_poly_ops():
    jp, tp = both("protocol.poly")
    q = both("fields.fr")[0].Q
    a, b = field_ints(207, q, 8), field_ints(208, q, 8)
    assert jp.ntt(a) == tp.ntt(a) and jp.i_ntt(a) == tp.i_ntt(a)
    pj = jp.Poly(a, jp.Basis.MONOMIAL) * jp.Poly(b, jp.Basis.MONOMIAL)
    pt = tp.Poly(a, tp.Basis.MONOMIAL) * tp.Poly(b, tp.Basis.MONOMIAL)
    assert pj.values == pt.values
    assert pj.eval(77) == pt.eval(77)
    assert (pj - pj.eval(5)).divide_by_linear(5).values == (pt - pt.eval(5)).divide_by_linear(5).values


@pytest.mark.parametrize("name", ["golden_proof.json", "golden_proof_mul_chain.json"])
def test_verifier_accepts_golden_bytes(name):
    """The port's Verifier (exact host engine) on the JAX package's frozen
    proof bytes; a flipped byte or a wrong public input is rejected."""
    from baby_plonk_tpu_torch.ops.engine import HostEngine
    from baby_plonk_tpu_torch.protocol import Program, Proof, Setup, Verifier

    with open(os.path.join(_DIR, name)) as f:
        fix = json.load(f)
    n = fix["group_order"]
    setup = Setup.generate_srs(n + 6, tau=fix["tau"], cache=False)
    program = Program.from_strs(fix["circuit"], n)
    wire = bytes.fromhex(fix["proof_hex"])
    public = [int(v, 16) if isinstance(v, str) else v for v in fix["public"]]
    engine = HostEngine()
    assert Verifier(setup, program, Proof.from_bytes(wire), engine=engine).verify(public)
    assert not Verifier(setup, program, Proof.from_bytes(wire), engine=engine).verify(
        [(public[0] + 1)] + public[1:])
    bad = bytearray(wire)
    bad[-1] ^= 1
    assert not Verifier(setup, program, Proof.from_bytes(bytes(bad)), engine=engine).verify(public)


def test_config_defaults(monkeypatch):
    for var in ("BPT_ENGINE", "BPT_MSM", "BPT_MSM_FIXED", "BPT_DEBUG_ASSERTS", "BPT_SRS_CACHE"):
        monkeypatch.delenv(var, raising=False)
    jc, tc = (m.Config() for m in both("config"))
    assert tc.engine == "torch" and jc.engine == "host"
    assert tc.srs_cache_dir.endswith("baby_plonk_tpu_torch")
    for field in ("debug_asserts", "msm_algorithm", "commit_fixed_base"):
        assert getattr(jc, field) == getattr(tc, field), field
    monkeypatch.setenv("BPT_MSM", "pippenger")
    monkeypatch.setenv("BPT_MSM_FIXED", "0")
    cfg = both("config")[1].Config()
    assert (cfg.msm_algorithm, cfg.commit_fixed_base) == ("pippenger", False)


def test_default_engine_selection(monkeypatch):
    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.ops import engine

    monkeypatch.setattr(engine, "_default_engine", None)
    monkeypatch.setattr(config, "_config", config.Config(engine="host"))
    assert isinstance(engine.get_default_engine(), engine.HostEngine)
    monkeypatch.setattr(engine, "_default_engine", None)
    monkeypatch.setattr(config, "_config", config.Config(engine="tpu"))
    with pytest.raises(ValueError):
        engine.get_default_engine()
