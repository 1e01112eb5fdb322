"""Shared helpers of the tests/test_torch_*.py files (the PyTorch port)."""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's plain CPU versions issue many tiny ops; torch's intra-op
    threads only add jitter there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def field_ints(seed: int, modulus: int, n: int) -> list[int]:
    """n canonical residues from a numpy seed."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, size=(n, (modulus.bit_length() + 31) // 32), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % modulus for row in words]


def g1_points(seed: int, n: int) -> list:
    """n host G1 points k_i G (the port's G1) with k_i from a numpy seed."""
    from baby_plonk_tpu_torch.curves.g1 import G1
    from baby_plonk_tpu_torch.fields import fr

    return [G1.generator() * (k or 1) for k in field_ints(seed, fr.Q, n)]


def affine(points) -> list:
    """Affine (x, y) int pairs (None = identity) of G1 points of either
    package: the canonical values the two packages are compared at."""
    return [p.to_affine() for p in points]


def jax_points(points) -> list:
    """The JAX package's own G1 objects for points of the port."""
    from baby_plonk_tpu.curves.g1 import G1

    return [G1.identity() if a is None else G1.from_affine(*a) for a in affine(points)]


def edge_groups() -> list:
    """8 groups of 8 port G1 points whose subset sums hit every special case
    of the table build: a point beside its negation (sums that cancel to
    the identity), repeated points (sums that double), identity points
    (Z = 0 inputs), and both at once."""
    from baby_plonk_tpu_torch.curves.g1 import G1

    P = g1_points(12, 16)
    O = G1.identity()
    return [
        [P[0], -P[0], P[1], P[2], -P[2], P[3], P[4], P[5]],
        [P[6]] * 8,
        [O] * 8,
        [O, P[7], O, -P[7], P[7], O, P[7] + P[7], P[8]],
        [P[9], P[9], -P[9], P[10], P[10], P[10] + P[10], -P[10], O],
        [P[11], P[12], P[13], P[11] + P[12], -(P[11] + P[12] + P[13]), P[14], P[15], -P[14]],
        P[0:8],
        [P[8], -P[8], P[8], -P[8], P[8], -P[8], P[8], -P[8]],
    ]
