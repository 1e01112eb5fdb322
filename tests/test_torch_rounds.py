"""The port's fused round expressions (plain CPU path: the unfused
expressions the CUDA kernels are held against on the card) and the inverse
NTT plan with 1/n folded in, against the JAX package's jitted functions on
inputs from a numpy seed. Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baby_plonk_tpu.fields import fr
from baby_plonk_tpu.ops import limbs as jl
from baby_plonk_tpu.ops import ntt as jntt
from baby_plonk_tpu.ops import prover_kernels as jpk
from baby_plonk_tpu.ops import tpu_engine as jte
from baby_plonk_tpu_torch.ops import kernels, ntt
from baby_plonk_tpu_torch.ops import prover_kernels as pk
from baby_plonk_tpu_torch.ops.limbs import FR
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine

from torch_port_util import field_ints, one_torch_thread  # noqa: F401  (fixture)

Q = fr.Q


def _rows(seed, count, n):
    """count rows of n residues -> (ints, JAX uint32 (16, n) arrays, port tensors)."""
    ints = [field_ints(seed + i, Q, n) for i in range(count)]
    arrs = [jntt.FR_SPEC.pack_mont(r) for r in ints]
    return ints, [jnp.asarray(a) for a in arrs], [torch.from_numpy(a.astype(np.int32)) for a in arrs]


def _jscalar(v):
    return jnp.asarray(jntt.FR_SPEC.pack_mont([v % Q]))


def test_round3_combine_matches_jax():
    m, shift = 32, 4
    _, jrows, trows = _rows(100, 16, m)
    (aE, bE, cE, zE, piE, s1E, s2E, s3E, qlE, qrE, qmE, qoE, qcE, l1E, zh_inv, dpow) = jrows
    beta, gamma, alpha, k1, k2 = field_ints(120, Q, 5)
    with jl.compact_mul():
        want = jpk._round3_combine_rows(
            aE, bE, cE, zE, jnp.roll(zE, -shift, axis=-1), s1E, s2E, s3E,
            qlE, qrE, qmE, qoE, qcE, piE, l1E, zh_inv, dpow,
            *(_jscalar(v) for v in (beta, gamma, alpha, alpha * alpha, k1, k2)))
    live = torch.stack(trows[:5], dim=1)
    fixed = torch.stack(trows[5:14], dim=1)
    sc = pk.scalars((beta, gamma, alpha, alpha * alpha, k1, k2), "cpu")
    before = pk.round3_combine.launches
    got = pk.round3_combine(live, fixed, trows[14], trows[15], sc, shift)
    assert pk.round3_combine.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    # the reference expression whatever the device gives the same limbs
    assert torch.equal(got, pk.round3_combine(live, fixed, trows[14], trows[15], sc, shift, plain=True))


def test_scalars_are_montgomery_columns():
    vals = [0, 1, Q - 1, 5]
    sc = pk.scalars(vals, "cpu")
    assert sc.shape == (16, 4) and sc.dtype == torch.int32
    assert FR.unpack_mont(sc) == vals
    assert torch.equal(sc[:, 3:4], FR.mont_scalar(5, "cpu"))


@pytest.fixture(scope="module")
def grand_product_case():
    n = 16
    ints, jrows, trows = _rows(200, 6, n)
    roots = fr.roots_of_unity(n)
    beta, gamma = field_ints(210, Q, 2)
    k1, k2 = 2, 3
    with jl.compact_mul():
        z, closing = jte._grand_product_full(
            *jrows, jnp.asarray(jntt.FR_SPEC.pack_mont(roots)),
            _jscalar(k1), _jscalar(k2), _jscalar(beta), _jscalar(gamma))
    return ints, trows, roots, (beta, gamma, k1, k2), np.asarray(z), np.asarray(closing)


def test_grand_product_fg_matches_ints(grand_product_case):
    ints, trows, roots, (beta, gamma, k1, k2), _, _ = grand_product_case
    a, b, c, s1, s2, s3 = ints
    f, g = pk.grand_product_fg(*trows, FR.pack_mont(roots, "cpu"), beta, gamma, k1, k2)
    rlc = lambda x, y: (x + beta * y + gamma) % Q
    assert FR.unpack_mont(f) == [
        rlc(a[i], roots[i]) * rlc(b[i], k1 * roots[i]) * rlc(c[i], k2 * roots[i]) % Q for i in range(16)]
    assert FR.unpack_mont(g) == [
        rlc(a[i], s1[i]) * rlc(b[i], s2[i]) * rlc(c[i], s3[i]) % Q for i in range(16)]


def test_grand_product_matches_jax_full(grand_product_case):
    """The whole round-2 product (fused f and g, two scans, one power) against
    the JAX package's single executable: z (16, n) and the closing value."""
    _, trows, roots, (beta, gamma, k1, k2), z, closing = grand_product_case
    got_z, got_closing = TorchEngine("cpu")._grand_product(
        *trows, FR.pack_mont(roots, "cpu"), beta, gamma, k1, k2)
    assert np.array_equal(got_z.numpy(), z.astype(np.int32))
    assert np.array_equal(got_closing.numpy(), closing.astype(np.int32))
    assert FR.unpack_mont(got_z)[0] == 1


@pytest.mark.parametrize("n", [8, 32])
def test_scaled_inverse_plan(n):
    """The inverse plan's cross twiddles carry 1/n; the forward plan's and the
    unscaled inverse's do not."""
    n1, n2 = ntt.split(n)
    w_inv, n_inv = pow(fr.root_of_unity(n), Q - 2, Q), pow(n, Q - 2, Q)
    plain = [pow(w_inv, j1 * i2, Q) for j1 in range(n1) for i2 in range(n2)]
    assert FR.unpack_mont(ntt.plan4(n, True, "cpu")[2].reshape(16, -1)) == plain
    assert FR.unpack_mont(ntt.plan4(n, True, "cpu", scaled=True)[2].reshape(16, -1)) == [
        v * n_inv % Q for v in plain]
    assert torch.equal(ntt.plan4(n, False, "cpu", scaled=True)[2], ntt.plan4(n, False, "cpu")[2])


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("n", [8, 32])
def test_scaled_four_step_through_forced_recursion(n, batch):
    """``ntt_sub_4step`` with the split limit lowered to 4 (a factor of 8
    recurses) and the 1/n folded into the top-level plan, against the JAX
    package's ``ntt_device``; the unscaled transform differs by exactly n."""
    ints = field_ints(300 + n + batch, Q, batch * n)
    j = jntt.FR_SPEC.pack_mont(ints).reshape(16, batch, n)
    t = torch.from_numpy(j.astype(np.int32)).reshape(16, batch, n, 1)
    with jl.compact_mul():
        want = np.asarray(jntt.ntt_device(jnp.asarray(j), True)).astype(np.int32)
    got = kernels.ntt_sub_4step(t, True, sub_max=4, scaled=True)
    assert np.array_equal(got.reshape(16, batch, n).numpy(), want)
    unscaled = kernels.ntt_sub_4step(t, True, sub_max=4)
    assert FR.unpack_mont(unscaled.reshape(16, -1)) == [v * n % Q for v in FR.unpack_mont(got.reshape(16, -1))]


@pytest.mark.parametrize("m", [2, 8, 64])
def test_stage_twiddles_layout(m):
    """(16, m - 1): the stage of half length len holds w^(off m / (2 len)),
    off < len, from column m - 2 len."""
    for inverse in (False, True):
        w = fr.root_of_unity(m)
        w = pow(w, Q - 2, Q) if inverse else w
        got = FR.unpack_mont(ntt.stage_twiddles(m, inverse, "cpu"))
        assert len(got) == m - 1
        length = m // 2
        while length >= 1:
            base = m - 2 * length
            assert got[base : base + length] == [pow(w, off * m // (2 * length), Q) for off in range(length)]
            length //= 2
