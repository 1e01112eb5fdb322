"""The port's sharded functions (baby_plonk_tpu_torch/parallel/) on meshes
of CPU shards, against the JAX package's single-device functions and its
exact host oracles, on inputs from a numpy seed. Exact (integers and
points). The last test, slow, holds them position for position against
the JAX package's own mesh functions on its virtual CPU mesh."""
import numpy as np
import pytest
import torch

from baby_plonk_tpu.curves import msm_host as jmsm_host
from baby_plonk_tpu.ops import limbs as jl
from baby_plonk_tpu.ops import ntt as jntt
from baby_plonk_tpu.ops.engine import HostEngine as JaxHostEngine
from baby_plonk_tpu_torch.curves import msm_host
from baby_plonk_tpu_torch.curves.g1 import G1
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, srs
from baby_plonk_tpu_torch.ops.limbs import FR
from baby_plonk_tpu_torch.ops.msm_fixed import FixedBaseTables
from baby_plonk_tpu_torch.parallel import dmsm, dntt, dscan, prove_step
from baby_plonk_tpu_torch.parallel.mesh import Mesh, make_mesh
from baby_plonk_tpu_torch.protocol import poly as hostpoly

from torch_port_util import affine, field_ints, g1_points, jax_points, one_torch_thread  # noqa: F401

Q = fr.Q
#: shards on two "devices" of the CPU (torch.device("cpu") and "cpu:0" are
#: distinct devices holding the same memory): shard d on device d mod 2, the
#: layout of D shards over two cards
TWO_DEVICES = ("cpu", "cpu:0")


def _jax_ntt(vals, inverse):
    with jl.compact_mul():
        return jntt.ntt_ints(vals, inverse)


def test_mesh_collectives():
    mesh = make_mesh(4, device="cpu")
    assert (mesh.D, mesh.physical, mesh.home) == (4, 1, torch.device("cpu"))
    x = torch.arange(2 * 3 * 16).reshape(2, 3, 16)
    shards = mesh.shard(x)
    assert [s.shape for s in shards] == [(2, 3, 4)] * 4
    assert torch.equal(mesh.gather(shards), x)
    assert all(torch.equal(g, x) for g in mesh.all_gather(shards))
    # tiled all_to_all: shard j gets chunk j of every shard, in sender order
    out = mesh.all_to_all(shards, -1, -2)
    for j, o in enumerate(out):
        assert torch.equal(o, torch.cat([s.chunk(4, dim=-1)[j] for s in shards], dim=-2))
    assert all(torch.equal(p, shards[(d + 1) % 4]) for d, p in enumerate(mesh.ppermute(shards, lambda d: (d + 1) % 4)))
    two = Mesh(TWO_DEVICES * 2)
    assert (two.D, two.physical) == (4, 2)
    with pytest.raises(ValueError):
        mesh.shard(torch.zeros(6))


def test_make_mesh_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        assert make_mesh(2).devices[1].type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_mesh(2)
    assert make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3


@pytest.mark.parametrize("D", [2, 4, 8])
def test_dntt_matches_jax_single_device(D):
    """Forward, inverse and the dual round trip; the natural-order result
    equals the JAX package's single-device NTT, and the cyclic output is it
    reordered by ``cyclic_perm``."""
    n = 64
    vals = field_ints(10 + D, Q, n)
    mesh = make_mesh(D, device="cpu")
    fwd, inv = _jax_ntt(vals, False), _jax_ntt(vals, True)
    assert dntt.ntt_ints_sharded(vals, mesh) == fwd
    assert dntt.ntt_ints_sharded(vals, mesh, inverse=True) == inv
    perm = prove_step.cyclic_perm(n, D)
    a = FR.pack_mont(vals, "cpu")
    assert FR.unpack_mont(dntt.ntt_sharded(a, mesh)) == [fwd[k] for k in perm]
    assert FR.unpack_mont(dntt.ntt_sharded(a, mesh, inverse=True)) == [inv[k] for k in perm]
    # the dual takes the cyclic layout back to natural order, batch rows and all
    batch = torch.stack([a, FR.pack_mont(inv, "cpu")], dim=1)
    cyc = dntt._local_fourstep(mesh.shard(batch), mesh, inverse=False)
    assert torch.equal(mesh.gather(dntt._local_fourstep_dual(cyc, mesh)), batch)
    with pytest.raises(ValueError):
        dntt.ntt_sharded(FR.pack_mont(vals[: 2 * D], "cpu"), make_mesh(2 * D, device="cpu"))


@pytest.mark.parametrize("devices", [("cpu",) * 2, TWO_DEVICES * 2], ids=["D2", "D4-two-devices"])
def test_msm_sharded_matches_host(devices):
    n = 21  # padded to D 2^k with zero scalars
    pts, scalars = g1_points(40, n), field_ints(41, Q, n)
    got = dmsm.msm_sharded(pts, scalars, Mesh(devices))
    assert got == msm_host.msm(pts, scalars)
    assert affine([got]) == affine([jmsm_host.msm(jax_points(pts), scalars)])


@pytest.mark.parametrize("devices", [("cpu",) * 4, TWO_DEVICES * 2], ids=["D4", "D4-two-devices"])
def test_msm_fixed_sharded_matches_host(devices):
    """Two scalar sets at once over shards of 8 points: the shards that
    share a device run as one table set, one chunk a shard."""
    mesh = Mesh(devices)
    n = 32
    pts = g1_points(50, n)
    point_shards = list(zip(*(mesh.shard(c) for c in g1_vec.points_to_device(pts, "cpu"))))
    tables = dmsm.build_tables_sharded(point_shards, mesh)
    assert sorted(d for idx, _ in tables for d in idx) == list(range(4))
    sets = [field_ints(51, Q, n), field_ints(52, Q, n - 5) + [0] * 5]
    scalar_shards = list(zip(*(mesh.shard(FR.pack_raw(s, "cpu")) for s in sets)))
    got = g1_vec.points_from_device(dmsm.msm_fixed_sharded(tables, [list(s) for s in scalar_shards], mesh))
    for g, s in zip(got, sets):
        assert g == msm_host.msm(pts, s)
        assert affine([g]) == affine([jmsm_host.msm(jax_points(pts), s)])


def test_fixed_base_sums_per_chunk():
    """``msm_many(per_chunk=True)`` gives each chunk's MSM apart."""
    pts, scalars = g1_points(60, 32), field_ints(61, Q, 32)
    tabs = FixedBaseTables(g1_vec.points_to_device(pts, "cpu"), chunk=8)
    out = g1_vec.points_from_device(tabs.msm_many([FR.pack_raw(scalars, "cpu")], per_chunk=True))
    assert out == [msm_host.msm(pts[8 * c : 8 * c + 8], scalars[8 * c : 8 * c + 8]) for c in range(4)]


def _grand_product_case(n, seed):
    roots = fr.roots_of_unity(1 << (n - 1).bit_length())[:n]
    cols = [field_ints(seed + i, Q, n) for i in range(6)]
    beta, gamma = field_ints(seed + 9, Q, 2)
    return (*cols, roots, beta, gamma, 2, 3)


@pytest.mark.parametrize("D", [2, 4, 3, 6])
def test_grand_product_sharded_matches_jax_host(D):
    """D = 3 and 6 are no powers of two: the totals fold pads with ones."""
    args = _grand_product_case(16 * D, 70 + D)
    assert dscan.grand_product_sharded(*args, make_mesh(D, device="cpu")) == JaxHostEngine().grand_product(*args)


def test_powers_of_tau_sharded():
    """Equal to ``srs.powers_of_tau_device`` lane for lane (the same
    kernel's plain version on the same lanes) and to the host's tau^i G."""
    powers, tau = 21, 31337  # no multiple of D = 2: one padding lane
    mesh = Mesh(TWO_DEVICES)
    shards = srs.powers_of_tau_sharded(powers, tau, mesh)
    assert [s[0].shape for s in shards] == [(24, 11)] * 2
    got = tuple(mesh.gather([s[k] for s in shards]) for k in range(3))
    assert not got[2][:, powers:].any()  # Z = 0: the identity
    got = tuple(c[:, :powers] for c in got)
    assert g1_vec.points_from_device(got) == [G1.generator() * pow(tau, i, Q) for i in range(powers)]
    # the first 8 lanes again through the unsharded function
    want = srs.powers_of_tau_device(8, tau, "cpu")
    assert all(torch.equal(g[:, :8], w) for g, w in zip(got, want))


def test_prove_step_sharded():
    """The sharded inverse NTT of three witness columns, then three sharded
    commits against the SRS in cyclic order, equal the host's commits of
    the columns' coefficients."""
    n, tau, D = 64, 9999, 4
    mesh = make_mesh(D, device="cpu")
    cols_ints = [field_ints(80 + i, Q, n) for i in range(3)]
    cols = torch.stack([FR.pack_mont(c, "cpu") for c in cols_ints], dim=1)
    host_srs = [G1.generator() * pow(tau, i, Q) for i in range(n)]
    pts = g1_vec.points_to_device(host_srs, "cpu")
    perm = torch.from_numpy(prove_step.cyclic_perm(n, D))
    outs = prove_step.prove_step_sharded(cols, *(c.index_select(-1, perm) for c in pts), mesh)
    for out, col in zip(outs, cols_ints):
        assert g1_vec.point_from_device(out) == msm_host.msm(host_srs, hostpoly.i_ntt(col))


@pytest.mark.slow
def test_positions_match_jax_mesh():
    """The port's cyclic output, grand product and commitments equal the
    JAX package's mesh functions on its virtual CPU mesh (D = 4), position
    for position."""
    import jax
    import jax.numpy as jnp

    from baby_plonk_tpu.parallel import dmsm as jdmsm, dntt as jdntt, dscan as jdscan
    from baby_plonk_tpu.parallel.mesh import make_mesh as jax_make_mesh

    D, n = 4, 64
    jmesh, mesh = jax_make_mesh(D), make_mesh(D, device="cpu")
    vals = field_ints(90, Q, n)
    for inverse in (False, True):
        want = np.asarray(jax.device_get(jdntt.ntt_sharded(jnp.asarray(jntt.FR_SPEC.pack_mont(vals)), jmesh, inverse)))
        got = dntt.ntt_sharded(FR.pack_mont(vals, "cpu"), mesh, inverse)
        assert np.array_equal(got.numpy(), want.astype(np.int32))
    args = _grand_product_case(n, 91)
    assert dscan.grand_product_sharded(*args, mesh) == jdscan.grand_product_sharded(*args, jmesh)
    pts, scalars = g1_points(92, 21), field_ints(93, Q, 21)
    assert affine([dmsm.msm_sharded(pts, scalars, mesh)]) == affine(
        [jdmsm.msm_sharded(jax_points(pts), scalars, jmesh)])
