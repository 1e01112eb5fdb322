"""Port sub-NTT, four-step composition and ntt_device (plain CPU path)
against the JAX package's NTT on the same inputs. Exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baby_plonk_tpu.fields import fr
from baby_plonk_tpu.ops import limbs as jl
from baby_plonk_tpu.ops import ntt as jntt
from baby_plonk_tpu.protocol import poly as hostpoly
from baby_plonk_tpu_torch.ops import kernels, ntt
from baby_plonk_tpu_torch.ops.limbs import FR

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)


def _values(seed, shape):
    """Fr residues for an array of ``shape``, flattened, from a seed."""
    return field_ints(seed, fr.Q, int(np.prod(shape)))


def _pack(ints, shape):
    """ints -> JAX uint32 (16, *shape) and port int32 (16, *shape)."""
    j = jntt.FR_SPEC.pack_mont(ints).reshape((16,) + shape)
    return j, torch.from_numpy(j.astype(np.int32))


def _axis2(a, m, inverse):
    """JAX stage loop along axis -2, natural order out (compact products)."""
    perm, tw, _ = jntt._plan(m, inverse)
    with jl.compact_mul():
        f = jax.jit(lambda x: jntt._ntt_axis2(x, m, jnp.asarray(tw), jnp.asarray(perm), 0))
        return np.asarray(f(jnp.asarray(a)))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_sub_matches_jax_axis2(inverse):
    m, B = 16, 8
    j, t = _pack(_values(1, (m, B)), (m, B))
    want = _axis2(j, m, inverse)
    out = kernels.ntt_sub(t.reshape(16, 1, m, B), inverse)  # bit-reversed rows
    br = torch.tensor(ntt.bit_reverse_perm(m))
    got = out.index_select(2, br).reshape(16, m, B)
    assert np.array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("sub_max", [8, 4])
def test_four_step_matches_jax_axis2(sub_max):
    """m = 64 with the split limit lowered: 8 x 8 directly (8), and a
    recursive second level (4)."""
    m, B = 64, 4
    j, t = _pack(_values(2, (m, B)), (m, B))
    for inverse in (False, True):
        want = _axis2(j, m, inverse)
        got = kernels.ntt_sub_4step(t.reshape(16, 1, m, B), inverse, sub_max=sub_max)
        assert np.array_equal(got.reshape(16, m, B).numpy(), want.astype(np.int32))


def test_ntt_ints_match_host():
    vals = _values(9, (64,))
    assert ntt.ntt_ints(vals, device="cpu") == hostpoly.ntt(vals)
    assert ntt.ntt_ints(vals, inverse=True, device="cpu") == hostpoly.i_ntt(vals)
    assert ntt.ntt_ints(ntt.ntt_ints(vals, device="cpu"), inverse=True, device="cpu") == vals
    with pytest.raises(TypeError):
        ntt.ntt_ints(vals)  # the device is the caller's choice, never a default


def test_plans():
    assert ntt.split(1 << 16) == (256, 256)
    assert ntt.split(1 << 18) == (512, 512)
    assert ntt.split(1 << 5) == (4, 8)
    assert ntt.bit_reverse_perm(8) == [0, 4, 2, 6, 1, 5, 3, 7]
    n1, n2, crossT, br1, br2 = ntt.plan4(32, False, "cpu")
    w = fr.root_of_unity(32)
    got = FR.unpack_mont(crossT.reshape(16, -1))
    assert got == [pow(w, j1 * i2, fr.Q) for j1 in range(n1) for i2 in range(n2)]
    # a block takes 8 columns (full 32-byte sectors), fewer where one block's
    # shared memory would not fit, and never more than divide the lanes
    assert kernels._columns_per_block(256, 256) == 8
    assert kernels._columns_per_block(512, 512) == 8
    assert kernels._columns_per_block(1024, 512) == 4
    assert kernels._columns_per_block(256, 12) == 4
    assert kernels._columns_per_block(16, 3) == 1
    assert kernels.sub_smem_bytes(256, 8) == 32 * (8 * 260 + 255)
    assert kernels.sub_smem_bytes(1024, 4) <= kernels.SMEM_BLOCK < kernels.sub_smem_bytes(1024, 8)
