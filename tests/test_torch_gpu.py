"""Card-only checks of the port's CUDA kernels against their plain
versions at small shapes (the full-size checks are chip_smoke.py's).
They skip where torch.cuda.is_available() is false."""
import os

import numpy as np
import pytest
import torch

from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import g1_vec, kernels, limbs, msm, msm_fixed, msm_pippenger, ntt, srs

from torch_port_util import edge_groups, field_ints

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu tests/test_torch_gpu.py)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("spec", [limbs.FR, limbs.FQ], ids=["fr", "fq"])
def test_field_ops(dev, spec):
    a = spec.pack_raw(field_ints(1, spec.modulus, 1000), dev)
    b = spec.pack_raw(field_ints(2, spec.modulus, 1000), dev)
    for fn, plain in ((limbs.mont_mul, limbs._mont_mul_plain), (limbs.add_mod, limbs._add_plain),
                      (limbs.sub_mod, limbs._sub_plain)):
        assert torch.equal(fn(spec, a, b).long(), plain(spec, a, b))
        assert torch.equal(fn(spec, a.reshape(spec.L, 10, 100), b[:, :100]).long(),
                           plain(spec, a.reshape(spec.L, 10, 100), b[:, :100]))
    assert torch.equal(limbs.neg_mod(spec, a).long(), limbs._neg_plain(spec, a))
    with pytest.raises(TypeError):
        limbs.mont_mul(spec, a.long(), b)
    with pytest.raises(ValueError):
        limbs.mont_mul(spec, a, b.cpu())


@pytest.mark.parametrize("m", [2, 8, 64, 1024])
def test_ntt_sub(dev, m):
    B = 4
    x = limbs.FR.pack_mont(field_ints(3, fr.Q, m * B), dev).reshape(16, 1, m, B)
    for inverse in (False, True):
        pw = ntt.sub_twiddles(m, inverse, dev)
        assert torch.equal(kernels.ntt_sub(x, inverse).long(), kernels.ntt_sub_plain(x, pw))


def test_ntt_device(dev):
    x = limbs.FR.pack_mont(field_ints(4, fr.Q, 3 * 4096), dev).reshape(16, 3, 4096)
    for inverse in (False, True):
        assert torch.equal(ntt.ntt_device(x, inverse), ntt.ntt_device(x, inverse, plain=True))
    assert torch.equal(ntt.ntt_device(ntt.ntt_device(x), inverse=True), x)


def test_prove_cpu_then_cuda_same_bytes(dev):
    """One program proved by the CPU engine, then by the CUDA engine (its
    proving key then holds CPU coefficient caches): equal proof bytes."""
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup

    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    program = Program.from_strs(["e public", "c <== a * b + b", "e <== c * d"], 8)
    witness, blinding = {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}, list(range(1, 12))
    cpu = Prover(setup, program, TorchEngine("cpu")).prove(witness, blinding=blinding)
    cuda = Prover(setup, program, TorchEngine(dev)).prove(witness, blinding=blinding)
    assert cpu.to_bytes() == cuda.to_bytes()


def test_product_and_square_edge_operands(dev):
    """0, 1, p - 1, R mod p, R^2 mod p, words of all ones below p and
    (p - 1)^2, every pair: a dropped carry shows here, not on random operands."""
    for spec in (limbs.FR, limbs.FQ):
        p, R = spec.modulus, 1 << (16 * spec.L)
        top = p >> (16 * spec.L - 32)
        ones = ((top - 1) << (16 * spec.L - 32)) | ((1 << (16 * spec.L - 32)) - 1)
        edge = [0, 1, p - 1, R % p, R * R % p, ones, (p - 1) ** 2 % p]
        a = spec.pack_raw([x for x in edge for _ in edge], dev)
        b = spec.pack_raw([y for _ in edge for y in edge], dev)
        assert torch.equal(limbs.mont_mul(spec, a, b).long(), limbs._mont_mul_plain(spec, a, b))
        assert torch.equal(limbs.mont_sqr(spec, a).long(), limbs._mont_mul_plain(spec, a, a))
        r = spec.pack_raw(field_ints(9, p, 1000), dev)
        assert torch.equal(limbs.mont_sqr(spec, r).long(), limbs._mont_mul_plain(spec, r, r))


def test_msm_and_srs(dev):
    pts = srs.powers_of_tau_device(64, 99, dev)
    cpu = srs.powers_of_tau_device(64, 99, "cpu")
    assert all(torch.equal(a.cpu(), b) for a, b in zip(pts, cpu))
    packed = msm_fixed.build_tables(*pts)
    assert packed.shape == (8, 256, 24)
    assert torch.equal(packed, msm_fixed.build_tables_plain(*pts))
    sc = limbs.FR.pack_raw(field_ints(5, fr.Q, 128), dev).reshape(16, 2, 64)
    got = msm_fixed.msm_fixed_horner(packed, sc, 1)
    want = msm_fixed.msm_fixed_plain(packed, sc, 1)
    assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    red = g1_vec.tree_reduce(got)
    assert g1_vec.points_from_device(red) == g1_vec.points_from_device(
        g1_vec.tree_reduce(tuple(c.cpu() for c in got)))
    np.testing.assert_equal(len(g1_vec.points_from_device(red)), 2)


def test_build_tables_edge_groups_ragged(dev):
    """The table build's three launches against the plain version on groups
    of cancelling, repeated and identity points, at group counts that leave
    a block of 4 groups part empty, and on 13 groups of SRS points."""
    pts = g1_vec.points_to_device([p for g in edge_groups() for p in g], dev)
    for G in (1, 3, 5, 8):
        sub = tuple(c[:, : 8 * G].contiguous() for c in pts)
        before = msm_fixed.build_tables.launches
        got = msm_fixed.build_tables(*sub)
        assert msm_fixed.build_tables.launches == before + 1
        assert torch.equal(got, msm_fixed.build_tables_plain(*sub)), G
    srs_pts = srs.powers_of_tau_device(8 * 13, 4242, dev)
    assert torch.equal(msm_fixed.build_tables(*srs_pts), msm_fixed.build_tables_plain(*srs_pts))


def test_powers_of_tau_edge_scalars_two_bases(dev):
    """The windowed kernel against its plain version limb for limb (each
    with a table of its own making) and against the host's multiples, for
    edge scalars at a lane count that leaves a block part empty, with the
    generator and a second base: each base gets its table on the card."""
    from baby_plonk_tpu_torch.curves.g1 import G1

    ints = [0, 1, 2, fr.Q - 1, fr.Q - 2, 1 << 254] + field_ints(31, fr.Q, 31)
    sc = limbs.FR.pack_raw(ints, dev)
    for point in (G1.generator(), G1.generator() * 0xC0FFEE):
        base = torch.cat(g1_vec.points_to_device([point], dev), dim=1)
        before = g1_vec.pdouble.launches
        chain = srs.doubling_chain(base)
        assert g1_vec.pdouble.launches == before + srs.CHAIN - 1
        assert all(torch.equal(g.long(), w) for g, w in zip(chain, srs.doubling_chain_plain(base)))
        before = srs.powers_of_tau.launches
        got = srs.powers_of_tau(sc, base)
        assert srs.powers_of_tau.launches == before + 1
        assert torch.equal(srs.base_table(base), msm_fixed.build_tables_plain(*srs.doubling_chain_plain(base)))
        want = srs.powers_of_tau_plain(sc, base)
        assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
        assert g1_vec.points_from_device(got) == [point * s for s in ints]
    assert len([k for k in srs.base_tables if k[0] == str(dev)]) >= 2


@pytest.mark.parametrize("windows", [1, 4, 8])
def test_windowed_horner_and_join(dev, windows):
    """The window split against its plain version, limb for limb, at a
    launch sized to ragged scalar sets (40 points, chunks of 16: 5 groups);
    the joined commit against the exact host MSM."""
    from baby_plonk_tpu_torch.curves import msm_host

    pts = srs.powers_of_tau_device(40, 55, dev)
    tabs = msm_fixed.FixedBaseTables(pts, chunk=16)
    ints = [field_ints(20 + k, fr.Q, k) for k in (40, 35, 1)]
    sets = [limbs.FR.pack_raw(v, dev) for v in ints]
    sc = torch.zeros((16, 3, 40), dtype=torch.int32, device=dev)
    for i, s in enumerate(sets):
        sc[:, i, : s.shape[-1]] = s
    got = msm_fixed.msm_fixed_horner(tabs.tables(), sc, windows)
    assert got[0].shape == (24, 3, windows, 5)
    want = msm_fixed.msm_fixed_plain(tabs.tables(), sc, windows)
    assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    win = g1_vec.combine_partials(got)
    S = msm_fixed.window_bits(windows)
    assert all(torch.equal(g.long(), w) for g, w in zip(msm_fixed.msm_join(win, S), msm_fixed.msm_join_plain(win, S)))
    host_pts = g1_vec.points_from_device(pts)
    assert g1_vec.points_from_device(tabs.msm_many(sets, windows=windows)) == [
        msm_host.msm(host_pts[: len(v)], v) for v in ints]


@pytest.mark.parametrize("K, windows", [(1, 1), (1, 4), (2, 1), (3, 1), (8, 1), (3, 2)])
def test_horner_groups_per_lane(dev, K, windows):
    """K groups a lane against the plain version, limb for limb: 13 groups
    (the edge groups, whose tables hold (0, 0) markers at nonzero indices,
    then SRS points) in chunks of 5, which K = 2, 3, 8 do not divide, and
    a ragged rest of 3; one group's scalars all zero (index 0 at every
    step) and a few zero scalars elsewhere; 2 sets, the second shorter."""
    edge = g1_vec.points_to_device([p for g in edge_groups() for p in g], dev)
    more = srs.powers_of_tau_device(40, 77, dev)
    packed = msm_fixed.build_tables(*(torch.cat([a, b], dim=-1) for a, b in zip(edge, more)))
    ints = field_ints(61, fr.Q, 2 * 104)
    ints[8:16] = [0] * 8
    ints[30], ints[77], ints[104 + 50 :] = 0, 0, [0] * 54
    sc = limbs.FR.pack_raw(ints, dev).reshape(16, 2, 104)
    before = msm_fixed.msm_fixed_horner.launches
    got = msm_fixed.msm_fixed_horner(packed, sc, windows, K, 5)
    assert msm_fixed.msm_fixed_horner.launches == before + 1
    per_chunk, rest = msm_fixed.lane_slots(13, K, 5)
    assert got[0].shape == (24, 2, windows, 2 * per_chunk + rest)
    want = msm_fixed.msm_fixed_plain(packed, sc, windows, K, 5)
    assert all(torch.equal(g.long(), w) for g, w in zip(got, want))


def test_msm_partials_and_pdouble(dev):
    """The bit-serial tile kernel and the doubling launcher against their
    plain versions, limb for limb; both MSM algorithms against the exact
    host MSM (ragged n, a zero scalar, Q - 1)."""
    from baby_plonk_tpu_torch.curves import msm_host

    n = 96
    pts = srs.powers_of_tau_device(n, 77, dev)
    ints = field_ints(6, fr.Q, n)
    ints[0], ints[1] = 0, fr.Q - 1
    sc = limbs.FR.pack_raw(ints, dev)
    for tile in (32, 8, 64, 256):  # 96 is no multiple of 64; 256 shrinks to 128
        got = msm.msm_partials(pts, sc, tile=tile)
        want = msm.msm_partials_plain(pts, sc, tile=tile)
        assert got[0].shape == (24, -(-n // min(tile, 128)))
        assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    for m in (5, 17, 40):  # ragged n at tile 8
        rag = (tuple(c[:, :m].contiguous() for c in pts), sc[:, :m].contiguous())
        got, want = msm.msm_partials(*rag, tile=8), msm.msm_partials_plain(*rag, tile=8)
        assert got[0].shape == (24, -(-m // 8))
        assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        msm.msm_partials(pts, sc, tile=48)  # no power of two
    dbl = g1_vec.pdouble(pts)
    assert all(torch.equal(g.long(), w) for g, w in zip(dbl, g1_vec.pdouble_plain(g1_vec._to64(pts))))
    # the shape the Pippenger window shift gives both launchers: one point, (24,) x3
    one, other = (tuple(c[:, i].contiguous() for c in pts) for i in (3, 4))
    assert all(torch.equal(g.long(), w) for g, w in zip(
        g1_vec.pdouble(one), g1_vec.pdouble_plain(g1_vec._to64(one))))
    assert all(torch.equal(g.long(), w) for g, w in zip(
        g1_vec.padd(one, other), g1_vec.padd_plain(g1_vec._to64(one), g1_vec._to64(other))))
    host = msm_host.msm(g1_vec.points_from_device(pts), ints)
    assert g1_vec.point_from_device(msm.msm_bitserial(pts, sc)) == host
    assert g1_vec.point_from_device(msm_pippenger.msm_pippenger(pts, sc, c=8)) == host


#: (scalars, c, plan (K, JOIN_K, L, BS)) of the Pippenger card test: small
#: plans split the chunks, join levels, segments and trees at n = 96; None
#: is the card's own plan
PIPPENGER_CASES = [
    ("random", 8, (4, 4, 2, 8)),
    ("random", 6, (5, 8, 4, 4)),
    ("all_equal", 8, (4, 4, 4, 16)),
    ("run_of_20", 8, (4, 4, 1, 128)),
    ("random", None, None),
    ("all_equal", None, None),
]


@pytest.mark.parametrize("scalars, c, plan", PIPPENGER_CASES,
                         ids=["c8", "c6", "all_equal", "run_of_20", "card_plan", "all_equal_card_plan"])
def test_msm_pippenger_kernel_matches_plain(dev, scalars, c, plan):
    """bpt_msm_pippenger against msm_pippenger_plain, limb for limb, one call
    a MSM; and the exact host MSM. Skewed: every scalar equal (one bucket a
    window holds every point), a run of 20 equal scalars across chunks."""
    from baby_plonk_tpu_torch.curves import msm_host

    n = 96
    pts = srs.powers_of_tau_device(n, 78, dev)
    ints = field_ints(7, fr.Q, n)
    if scalars == "all_equal":
        ints = [ints[0]] * n
    elif scalars == "run_of_20":
        ints[30:50] = [ints[30]] * 20
    sc = limbs.FR.pack_raw(ints, dev)
    cc = msm_pippenger.window_c(n) if c is None else c
    card_plan = plan or msm_pippenger.make_plan(n, cc, torch.cuda.get_device_properties(dev).multi_processor_count)
    before = msm_pippenger.msm_pippenger.launches
    got = msm_pippenger.msm_pippenger(pts, sc, c=c, plan=plan)
    torch.cuda.synchronize()
    assert msm_pippenger.msm_pippenger.launches == before + 1
    want = msm_pippenger.msm_pippenger_plain(pts, sc, cc, card_plan)
    assert all(torch.equal(g.long(), w) for g, w in zip(got, want))
    assert g1_vec.point_from_device(got) == msm_host.msm(g1_vec.points_from_device(pts), ints)


def _tree_input(dev, shape, seed):
    """(24, *shape) x3 canonical Fq residues (the tree's formula is defined
    on any), with the identity (0 : 1 : 0) in lane 1 of every set and lane
    n/2 equal to lane 0 (the doubling case at the first level)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        a = rng.integers(0, 1 << 16, size=(24,) + shape, dtype=np.int64)
        a[-1] %= limbs.FQ.modulus >> (16 * 23)
        out.append(torch.from_numpy(a.astype(np.int32)).to(dev))
    n = shape[-1]
    if n >= 4:
        for c, v in zip(out, g1_vec.pidentity((), dev)):
            c[..., 1] = v.reshape((24,) + (1,) * (c.dim() - 2))
        for c in out:
            c[..., n // 2] = c[..., 0]
    return tuple(out)


@pytest.mark.parametrize("shape", [(3, 1), (5, 2), (3, 2, 8), (1024,), (2, 2048), (4096,)],
                         ids=["n1", "n2", "n8", "n1024", "n2048", "n4096"])
def test_g1_tree_one_launch(dev, shape):
    """bpt_g1_tree against tree_reduce_plain, limb for limb: one launch a
    call, no elementwise addition launch."""
    p = _tree_input(dev, shape, 60 + shape[-1])
    before = (g1_vec.tree_reduce.launches, g1_vec.padd.launches)
    got = g1_vec.tree_reduce(p)
    assert (g1_vec.tree_reduce.launches, g1_vec.padd.launches) == (before[0] + 1, before[1])
    want = g1_vec.tree_reduce_plain(p)
    assert all(g.shape == (24,) + shape[:-1] and torch.equal(g, w) for g, w in zip(got, want))


def test_g1_tree_strided_view_and_refusals(dev):
    """The fixed-base MSM's view of its partials, (24, P, W, full, 2048)
    over the first full chunks of (24, P, W, G), read in place; a view
    whose batch axes do not fold, copied once; the refusals."""
    part = _tree_input(dev, (3, 2, 4 * 2048 + 1), 70)
    whole = tuple(c[..., : 4 * 2048].reshape(24, 3, 2, 4, 2048) for c in part)
    assert g1_vec.tree_layout(whole[0]) is not None
    crossed = tuple(c.transpose(1, 2)[..., :32].reshape(24, 2, 3, 4, 8) for c in part)
    assert g1_vec.tree_layout(crossed[0]) is None
    for p in (whole, crossed):
        before = g1_vec.tree_reduce.launches
        got = g1_vec.tree_reduce(p)
        assert g1_vec.tree_reduce.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, g1_vec.tree_reduce_plain(p)))
    with pytest.raises(ValueError, match="power of two"):
        g1_vec.tree_reduce(tuple(c[..., :6] for c in part))
    with pytest.raises(TypeError):
        g1_vec.tree_reduce(tuple(c.long() for c in whole))
    with pytest.raises(ValueError):
        g1_vec.tree_reduce((whole[0].cpu(),) + whole[1:])
    with pytest.raises(ValueError):
        g1_vec.tree_reduce(tuple(c[:12] for c in whole))


@pytest.mark.parametrize("spec", [limbs.FR, limbs.FQ], ids=["fr", "fq"])
def test_field_pow_one_launch(dev, spec):
    """a^e in the kernel against square-and-multiply over the plain product:
    one lane and 1000, the edge values 0, 1 and p - 1, e = p - 2 and small e."""
    p = spec.modulus
    for lanes in ([7], [0, 1, p - 1] + field_ints(11, p, 997)):
        a = spec.pack_mont(lanes, dev)
        for e in (p - 2, 1, 2, 5, (1 << 200) + 1):
            before = limbs.mont_pow_fixed.launches
            got = limbs.mont_pow_fixed(spec, a, e)
            assert limbs.mont_pow_fixed.launches == before + 1
            assert torch.equal(got.long(), limbs._mont_pow_plain(spec, a, e))
        assert spec.unpack_mont(limbs.mont_pow_fixed(spec, a, 0)) == [1] * len(lanes)
    inv = spec.unpack_mont(limbs.mont_pow_fixed(spec, spec.pack_mont([0, 1, p - 1, 12345], dev), p - 2))
    assert inv == [0, 1, p - 1, pow(12345, -1, p)]


@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("n", [1, 5, 255, 256, 257, 3000, 66000])
def test_field_scan(dev, op, n):
    """The one-pass scan against the doubling scan: both operators, forward
    and reversed, inclusive and exclusive, a ragged n, one tile and several,
    more tiles than one block of the prefix launch takes (66000), batch rows."""
    spec = limbs.FR
    rows = 1 if n > 3000 else 3
    x = spec.pack_mont(field_ints(12 + n, spec.modulus, rows * n), dev).reshape(16, rows, n)
    for reverse in (False, True):
        for exclusive in (False, True):
            got, total = limbs.field_scan(spec, x, op, reverse, exclusive)
            want, want_total = limbs.field_scan(spec, x, op, reverse, exclusive, plain=True)
            assert got.shape == x.shape and total.shape == (16, rows, 1)
            assert torch.equal(got, want), (reverse, exclusive)
            assert torch.equal(total, want_total)
    fq = limbs.FQ
    y = fq.pack_mont(field_ints(13, fq.modulus, min(n, 600)), dev)
    assert torch.equal(limbs.field_scan(fq, y, op, True, True)[0], limbs.field_scan(fq, y, op, True, True, plain=True)[0])


@pytest.mark.parametrize("n", [1, 2, 127, 128, 1025, 5000])
def test_pow_table(dev, n):
    for spec in (limbs.FR, limbs.FQ):
        z = spec.pack_mont(field_ints(14, spec.modulus, 1), dev)
        assert torch.equal(limbs.pow_table(spec, z, n), limbs.pow_table(spec, z, n, plain=True))
    z = limbs.FR.pack_mont([3], dev)
    assert limbs.FR.unpack_mont(limbs.pow_table(limbs.FR, z, n)) == [pow(3, i, fr.Q) for i in range(n)]


def test_batch_inverse(dev):
    for spec in (limbs.FR, limbs.FQ):
        xs = field_ints(15, spec.modulus, 700)
        xs[3] = 0
        got = spec.unpack_mont(limbs.batch_inverse(spec, spec.pack_mont(xs, dev)))
        assert got == [pow(x, -1, spec.modulus) if x else 0 for x in xs]


def test_fused_round_expressions(dev):
    """bpt_round3_combine and bpt_grand_product_fg against the unfused
    expressions over the plain field operations (m = 96 is no multiple of the
    block; the rolled read of z wraps)."""
    from baby_plonk_tpu_torch.ops import prover_kernels as pk

    m = 96
    pack = lambda seed, shape: limbs.FR.pack_mont(field_ints(seed, fr.Q, int(np.prod(shape))), dev).reshape((16,) + shape)
    live, fixed = pack(30, (5, m)), pack(31, (9, m))
    zh_inv, dpow, sc = pack(32, (m,)), pack(33, (m,)), pk.scalars(field_ints(34, fr.Q, 6), dev)
    before = pk.round3_combine.launches
    got = pk.round3_combine(live, fixed, zh_inv, dpow, sc, 4)
    assert pk.round3_combine.launches == before + 1
    assert torch.equal(got, pk.round3_combine(live, fixed, zh_inv, dpow, sc, 4, plain=True))
    rows = [pack(40 + i, (m,)) for i in range(7)]
    scal = field_ints(50, fr.Q, 4)
    f, g = pk.grand_product_fg(*rows, *scal)
    pf, pg = pk.grand_product_fg(*rows, *scal, plain=True)
    assert torch.equal(f, pf) and torch.equal(g, pg)


@pytest.mark.parametrize("K,m,B,sub_max", [(3, 4096, 1, None), (2, 64, 3, None), (1, 2, 4, None),
                                           (1, 8, 1, None), (2, 64, 2, 4), (1, 1 << 18, 1, None)])
def test_four_step_two_launches(dev, K, m, B, sub_max):
    """The two-launch four-step transform against the composition of the
    plain passes, forward, inverse and scaled inverse; an inner batch axis;
    a forced recursion (sub_max 4); exactly two kernel launches a transform
    when both factors fit a block."""
    x = limbs.FR.pack_mont(field_ints(60 + m, fr.Q, K * m * B), dev).reshape(16, K, m, B)
    for inverse, scaled in ((False, False), (True, False), (True, True)):
        before = kernels.ntt_sub.launches
        got = kernels.ntt_sub_4step(x, inverse, sub_max, scaled=scaled)
        launched = kernels.ntt_sub.launches - before
        if m <= 4096 or not inverse:
            want = kernels.ntt_sub_4step(x, inverse, sub_max, plain=True, scaled=scaled)
            assert torch.equal(got, want), (inverse, scaled)
        if sub_max is None and m >= 4:
            assert launched == 2
    back = kernels.ntt_sub_4step(kernels.ntt_sub_4step(x, False, sub_max), True, sub_max, scaled=True)
    assert torch.equal(back, x)


def test_sub_ntt_shared_memory_plan(dev):
    lib = kernels.library()
    for m, c in ((2, 1), (256, 8), (512, 8), (1024, 4), (64, 2)):
        assert lib.bpt_ntt_sub_smem(m, c) == kernels.sub_smem_bytes(m, c)
    assert kernels.sub_smem_bytes(1024, kernels._columns_per_block(1024, 1024)) <= kernels.SMEM_BLOCK
    # m = 1024 needs the opt-in above 48 KB
    x = limbs.FR.pack_mont(field_ints(70, fr.Q, 1024 * 8), dev).reshape(16, 1, 1024, 8)
    pw = ntt.sub_twiddles(1024, False, dev)
    assert torch.equal(kernels.ntt_sub(x, False).long(), kernels.ntt_sub_plain(x, pw))


def test_device_srs_cache_round_trip(dev, tmp_path, monkeypatch):
    """The device SRS at 2^10 through its disk cache on the card: written by
    the first call, read back by the second to equal tensors on the card."""
    from baby_plonk_tpu_torch import config
    from baby_plonk_tpu_torch.protocol import Setup
    from baby_plonk_tpu_torch.protocol.setup import device_srs_path

    monkeypatch.setattr(config, "_config", config.Config(srs_cache_dir=str(tmp_path)))
    made = Setup.generate_srs_device(1 << 10, 4242, cache=True, device=dev)
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(device_srs_path(1 << 10, 4242))]
    loaded = Setup.generate_srs_device(1 << 10, 4242, cache=True, device=dev)
    got, want = loaded.device_points[str(dev)], made.device_points[str(dev)]
    assert all(g.device == want[0].device and torch.equal(g, w) for g, w in zip(got, want))
    assert loaded.x_2 == made.x_2


def test_round3_combine_zw_row(dev):
    """bpt_round3_combine with z(w x) read from a row of its own (the mesh's
    cross-shard z) against its plain version; z's own row as that row gives
    the kernel's single-device reading."""
    from baby_plonk_tpu_torch.ops import prover_kernels as pk

    m = 96
    pack = lambda seed, shape: limbs.FR.pack_mont(field_ints(seed, fr.Q, int(np.prod(shape))), dev).reshape((16,) + shape)
    live, fixed, zw = pack(35, (5, m)), pack(36, (9, m)), pack(37, (m,))
    zh_inv, dpow, sc = pack(38, (m,)), pack(39, (m,)), pk.scalars(field_ints(34, fr.Q, 6), dev)
    for shift in (0, 1, 95):
        before = pk.round3_combine.launches, pk.round3_combine.launches_zw
        got = pk.round3_combine(live, fixed, zh_inv, dpow, sc, shift, zw=zw)
        assert (pk.round3_combine.launches, pk.round3_combine.launches_zw) == (before[0], before[1] + 1)
        assert torch.equal(got, pk.round3_combine(live, fixed, zh_inv, dpow, sc, shift, zw=zw, plain=True))
    assert torch.equal(pk.round3_combine(live, fixed, zh_inv, dpow, sc, 4, zw=live[:, 3]),
                       pk.round3_combine(live, fixed, zh_inv, dpow, sc, 4))


@pytest.mark.parametrize("D", [4, 8])
def test_mesh_prove_equals_torch_engine(dev, D):
    """A mesh prove at n = 32 with D shards over the visible cards (shard d
    on card d mod the count): TorchEngine's proof bytes."""
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.parallel.mesh import make_mesh
    from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier, mul_chain

    n = 32
    constraints, witness, public = mul_chain(n)
    program = Program.from_strs(constraints, n)
    setup = Setup.generate_srs_device(n + 6, 4242, cache=False, device=dev)
    blinding = list(range(1, 12))
    want = Prover(setup, program, TorchEngine(dev)).prove(witness, blinding=blinding)
    engine = MeshEngine(make_mesh(D))
    before = kernels.ntt_sub.launches
    got = Prover(setup, program, engine).prove(witness, blinding=blinding)
    assert kernels.ntt_sub.launches > before
    assert got.to_bytes() == want.to_bytes()
    assert Verifier(setup, program, got, engine=engine).verify(public)


def test_launch_on_a_second_card():
    """A kernel on a tensor of cuda:1 while the current device is 0:
    ``kernels.launch`` switches the device for the launch (and the sub-NTT's
    shared-memory opt-in is made for that card too)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    a = limbs.FR.pack_raw(field_ints(1, fr.Q, 1000), d1)
    b = limbs.FR.pack_raw(field_ints(2, fr.Q, 1000), d1)
    assert torch.equal(limbs.mont_mul(limbs.FR, a, b).long(), limbs._mont_mul_plain(limbs.FR, a, b))
    x = limbs.FR.pack_mont(field_ints(70, fr.Q, 1024 * 8), d1).reshape(16, 1, 1024, 8)
    assert torch.equal(kernels.ntt_sub(x, False).long(), kernels.ntt_sub_plain(x, ntt.sub_twiddles(1024, False, d1)))
    assert torch.cuda.current_device() == 0


def test_process_mesh_gloo_on_the_card(dev, tmp_path):
    """Two processes over gloo, D = 4 at n = 32 (both processes on cuda:0
    with one card, the bytes in flight staged through the host): each proves
    TorchEngine's bytes on its own card and verifies."""
    from baby_plonk_tpu_torch.parallel import multihost_smoke

    results = multihost_smoke.spawn(multihost_smoke.smoke, (4, 5, True), 2, "gloo", "cuda", 300, dir=tmp_path)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["backend"] == "gloo" and r["collectives"] > 0 for r in results)


def test_process_mesh_nccl(dev, tmp_path):
    """Two processes over nccl, one card each, D = 8 at n = 32 (round 3's
    z(w x) rows from the other process): TorchEngine's bytes, verified."""
    from baby_plonk_tpu_torch.parallel import multihost_smoke

    if torch.cuda.device_count() < 2:
        pytest.skip("nccl needs one card a process: two CUDA devices")
    results = multihost_smoke.spawn(multihost_smoke.smoke, (8, 5, True), 2, "nccl", "cuda", 300, dir=tmp_path)
    assert [r["device"] for r in results] == ["cuda:0", "cuda:1"]
    assert all(r["backend"] == "nccl" and r["collectives"] > 0 for r in results)


def test_forced_memory_governors_prove_equals_default(dev, monkeypatch):
    """A 2^10-gate prove on the card with the four memory governors forced
    (round 4 and round 5 in position chunks of 2^7, both round-3 budgets 0:
    nothing cached) gives the default prove's bytes, and the proof verifies."""
    from baby_plonk_tpu_torch.ops import dpoly, prover_kernels
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier, mul_chain

    n = 1 << 10
    setup = Setup.generate_srs_device(n + 6, 101, cache=False, device=dev)
    constraints, witness, public = mul_chain(n)
    engine, blinding = TorchEngine(dev), list(range(1, 12))
    proofs = []
    for forced in (False, True):
        if forced:
            monkeypatch.setattr(dpoly, "EVAL_CHUNK", 1 << 7)
            monkeypatch.setattr(prover_kernels, "COMBINE_CHUNK", 1 << 7)
            monkeypatch.setattr(prover_kernels, "R3_CONSTS_SHARE", 0)
            monkeypatch.setattr(prover_kernels, "R3_ROWCACHE_SHARE", 0)
        monkeypatch.setattr(prover_kernels, "_R3_CONSTS", {})
        program = Program.from_strs(constraints, n)
        proofs.append(Prover(setup, program, engine).prove(witness, blinding=blinding))
        cached = program.common_preprocessed_input().coset_rows is not None
        assert cached == (not forced) == bool(prover_kernels._R3_CONSTS)
    assert proofs[0].to_bytes() == proofs[1].to_bytes()
    assert Verifier(setup, program, proofs[1], engine=engine).verify(public)
