"""State carried between the two packages through ``convert``: SRS points,
``x_2``, proof bytes and programs go over as ints, bytes and numpy arrays
and come back equal. Tolerance: exact."""
import json
import os

import numpy as np
import pytest

from baby_plonk_tpu.ops import g1_vec as jg1
from baby_plonk_tpu.protocol.program import Program as JProgram
from baby_plonk_tpu.protocol.proof import Proof as JProof
from baby_plonk_tpu.protocol.setup import Setup as JSetup
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.ops import g1_vec
from baby_plonk_tpu_torch.protocol import Proof, Setup

from torch_port_util import affine, one_torch_thread  # noqa: F401  (fixture)

_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
POWERS, TAU = 6, 424242


@pytest.fixture(scope="module")
def jax_setup():
    return JSetup.generate_srs(POWERS, TAU, cache=False)


def test_srs_affine_round_trip(jax_setup):
    """JAX-package SRS -> affine int pairs + compressed x_2 -> the port's
    Setup, equal to the port's own SRS, and back to the same pairs."""
    pairs = affine(jax_setup.powers_of_x)
    setup = convert.setup_from_affine(pairs, jax_setup.x_2.to_compressed())
    own = Setup.generate_srs(POWERS, TAU, cache=False)
    assert setup.powers_of_x == own.powers_of_x and setup.x_2 == own.x_2
    assert convert.setup_to_affine(setup) == pairs
    assert setup.x_2.to_compressed() == jax_setup.x_2.to_compressed()
    with_identity = convert.setup_from_affine([None] + pairs[:2], convert.g2_coords(jax_setup.x_2))
    assert with_identity.powers_of_x[0].is_identity() and with_identity.x_2 == own.x_2


def test_srs_limbs_round_trip(jax_setup):
    """The JAX package's (24, n) limb arrays -> the port's device Setup ->
    the same arrays; the port commits with them."""
    limbs_j = tuple(np.asarray(c) for c in jg1.points_to_device(jax_setup.powers_of_x))
    setup = convert.setup_from_limbs(limbs_j, convert.g2_coords(jax_setup.x_2), "cpu")
    assert setup.powers_of_x is None and setup.srs_len() == POWERS
    for got, want in zip(convert.setup_to_limbs(setup, "cpu"), limbs_j):
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    (pts,) = setup.device_points.values()
    assert affine(g1_vec.points_from_device(pts)) == affine(jax_setup.powers_of_x)
    with pytest.raises(ValueError):
        convert.setup_from_limbs(limbs_j[:2], convert.g2_coords(jax_setup.x_2), "cpu")


def test_x2_forms(jax_setup):
    a = convert.g2_from(jax_setup.x_2.to_compressed())
    b = convert.g2_from(convert.g2_coords(jax_setup.x_2))
    assert a == b and convert.g2_coords(b) == convert.g2_coords(jax_setup.x_2)
    with pytest.raises(ValueError):
        convert.g2_from(b"\x00" * 96)
    with pytest.raises(ValueError):
        convert.g2_from((1, 2, 3))


def test_proof_bytes_round_trip():
    with open(os.path.join(_DIR, "golden_proof.json")) as f:
        wire = bytes.fromhex(json.load(f)["proof_hex"])
    proof = convert.proof_from_bytes(wire)
    assert isinstance(proof, Proof) and proof.to_bytes() == wire
    jproof = JProof.from_bytes(wire)
    assert jproof.to_bytes() == wire
    assert proof.a_1.to_affine() == jproof.a_1.to_affine() and proof.a_bar == jproof.a_bar


def test_program_round_trip():
    lines = ["e public", "c <== a * b + b", "e <== c * d"]
    program = convert.program_from_strs(lines, 8)
    jprogram = JProgram.from_strs(lines, 8)
    assert program.group_order == jprogram.group_order
    assert program.coeffs() == jprogram.coeffs()
    pk, jpk = program.common_preprocessed_input(), jprogram.common_preprocessed_input()
    for k in ("ql", "qr", "qm", "qo", "qc", "s1", "s2", "s3"):
        assert getattr(pk, k).values == getattr(jpk, k).values, k
