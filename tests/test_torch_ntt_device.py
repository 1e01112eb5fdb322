"""Port ntt_device (plain CPU path) against the JAX package's ntt_device
on the same inputs, one polynomial (16, n) and a batch of 8 (16, 8, n).
Exact."""
import jax.numpy as jnp
import numpy as np
import pytest

from baby_plonk_tpu.ops import limbs as jl
from baby_plonk_tpu.ops import ntt as jntt
from baby_plonk_tpu_torch.ops import ntt

from test_torch_ntt import _pack, _values
from torch_port_util import one_torch_thread  # noqa: F401  (fixture)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("n", [8, 32])
def test_ntt_device_matches_jax(n, batch):
    shape = (batch, n) if batch > 1 else (n,)
    j, t = _pack(_values(3 + n + batch, shape), shape)
    for inverse in (False, True):
        with jl.compact_mul():
            want = np.asarray(jntt.ntt_device(jnp.asarray(j), inverse))
        got = ntt.ntt_device(t, inverse)
        assert np.array_equal(got.numpy(), want.astype(np.int32)), inverse
