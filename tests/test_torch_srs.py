"""Port powers of tau (plain CPU path) against the JAX package's
srs._fixed_base_kernel and the host SRS chain."""
import jax.numpy as jnp
import numpy as np

from baby_plonk_tpu.ops import srs as jsrs
from baby_plonk_tpu_torch import convert
from baby_plonk_tpu_torch.ops import g1_vec, srs
from baby_plonk_tpu_torch.protocol.setup import Setup

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)


def test_powers_of_tau_match_jax_and_host():
    powers, tau = 6, 54321
    sc = srs.tau_scalars(powers, tau, "cpu")
    base = srs.generator_base("cpu")
    got = srs.powers_of_tau(sc, base)
    jbase = [jnp.tile(jnp.asarray(convert.to_numpy(base[:, i : i + 1])), (1, powers)) for i in range(3)]
    want = jsrs._fixed_base_kernel(*jbase, jnp.asarray(convert.to_numpy(sc)))
    for g, w in zip(convert.srs_to_numpy(got), want):
        assert np.array_equal(g, np.asarray(w))
    assert g1_vec.points_from_device(got) == Setup.generate_srs(powers, tau, cache=False).powers_of_x


def test_generate_srs_device_setup():
    setup = Setup.generate_srs_device(5, 777, cache=False, device="cpu")
    host = Setup.generate_srs(5, 777, cache=False)
    assert setup.powers_of_x is None and setup.srs_len() == 5
    assert setup.x_2 == host.x_2
    (pts,) = setup.device_points.values()
    assert g1_vec.points_from_device(pts) == host.powers_of_x
    setup.materialize_host()
    assert setup.powers_of_x == host.powers_of_x
