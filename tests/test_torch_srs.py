"""Port powers of tau (plain CPU path) against the JAX package's
srs._fixed_base_kernel and the host SRS chain, at affine points: the port
windows over a table of the base's multiples, the reference doubles and
adds, so the projective coordinates differ and the points do not."""
import jax.numpy as jnp
import numpy as np
import torch

from baby_plonk_tpu.ops import srs as jsrs
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, limbs, msm_fixed, srs
from baby_plonk_tpu_torch.protocol.setup import Setup

from torch_port_util import affine, field_ints, one_torch_thread  # noqa: F401  (fixture)

TAU = 54321
#: edge scalars, then tau^1..tau^4 and two random ones: one JAX shape (10
#: lanes) for both bases, so its kernel compiles once
SCALARS = [0, 1, 2, fr.Q - 1] + [pow(TAU, i, fr.Q) for i in range(1, 5)] + field_ints(3, fr.Q, 2)


def _jax_points(base, sc):
    """The JAX kernel's multiples of ``base`` (24, 3) for the raw scalars
    ``sc`` (16, n), brought back as the port's host points."""
    n = sc.shape[-1]
    jbase = [jnp.tile(jnp.asarray(convert.to_numpy(base[:, i : i + 1])), (1, n)) for i in range(3)]
    want = jsrs._fixed_base_kernel(*jbase, jnp.asarray(convert.to_numpy(sc)))
    return g1_vec.points_from_device(convert.srs_to_torch([np.asarray(w) for w in want], "cpu"))


def test_powers_of_tau_match_jax_and_host():
    sc = limbs.FR.pack_raw(SCALARS, "cpu")
    base = srs.generator_base("cpu")
    got = g1_vec.points_from_device(srs.powers_of_tau(sc, base))
    assert affine(got) == affine(_jax_points(base, sc))
    assert affine(got) == affine([G1.generator() * s for s in SCALARS])
    assert got[0].is_identity()
    powers = srs.powers_of_tau_device(6, TAU, "cpu")
    assert g1_vec.points_from_device(powers) == Setup.generate_srs(6, TAU, cache=False).powers_of_x


def test_powers_of_tau_other_base():
    """A second base gets a table of its own, kept beside the generator's."""
    other = G1.generator() * 0xC0FFEE
    base = torch.cat(g1_vec.points_to_device([other], "cpu"), dim=1)
    sc = limbs.FR.pack_raw(SCALARS, "cpu")
    got = g1_vec.points_from_device(srs.powers_of_tau(sc, base))
    assert affine(got) == affine(_jax_points(base, sc))
    assert affine(got) == affine([other * s for s in SCALARS])
    table = srs.base_table(base)
    assert srs.base_table(base) is table  # kept, not built again
    assert srs.base_table(srs.generator_base("cpu")) is not table


def test_generator_table_matches_host_multiples():
    """Entry [k][d] of the generator's table is d 2^(8k) G, affine; entry 0
    of every window is the (0, 0) marker."""
    table = srs.base_table(srs.generator_base("cpu"))
    assert table.shape == (srs.WINDOWS, 256, 24)
    assert not table[:, 0].any()
    tx, ty = msm_fixed.unpack_tables(table)
    for k in (0, 1, 17, 31):
        xs, ys = (g1_vec.FQ.unpack_mont(t[:, k]) for t in (tx, ty))
        step = G1.generator() * (1 << (8 * k))
        acc = G1.identity()
        for d in range(1, 256):
            acc = acc + step
            assert (xs[d], ys[d]) == acc.to_affine(), (k, d)


def test_doubling_chain():
    chain = g1_vec.points_from_device(srs.doubling_chain(srs.generator_base("cpu")))
    assert len(chain) == srs.CHAIN
    assert chain[0] == G1.generator() and chain[200] == G1.generator() * (1 << 200)
    assert all(b == a + a for a, b in zip(chain[:8], chain[1:9]))


def test_generate_srs_device_setup():
    setup = Setup.generate_srs_device(5, 777, cache=False, device="cpu")
    host = Setup.generate_srs(5, 777, cache=False)
    assert setup.powers_of_x is None and setup.srs_len() == 5
    assert setup.x_2 == host.x_2
    (pts,) = setup.device_points.values()
    assert g1_vec.points_from_device(pts) == host.powers_of_x
    setup.materialize_host()
    assert setup.powers_of_x == host.powers_of_x
