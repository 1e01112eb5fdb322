"""Fixed-base MSM for KZG commits: per-SRS subset-sum tables and the
windowed Horner loop over them (counterpart of
``baby_plonk_tpu/ops/msm_fixed.py``).

Points are grouped 8 at a time; for each group the 256 subset sums
T[g][idx] = sum_{j in idx} P_{8g+j} are built once per SRS and stored
affine, entry-major and packed: (G, 256, 24) int32, one entry = the 12
32-bit words of x, then those of y (two 16-bit limbs a word), the identity
as the (0, 0) marker. ``unpack_tables`` gives the JAX package's layout,
two (24, G, 256) limb arrays.

A commit cuts the 255 scalar bits into W windows of S = ceil(255 / W) bits.
A lane is (scalar set, window, slice), a slice being up to K groups of one
chunk (``lane_slots``), and runs its window's Horner steps, MSB first,
acc = 2 acc + sum_k T[g_k][bits of group g_k's 8 scalars]: one doubling a
step for the K groups, since sum_g sum_b 2^b T_g[idx_g(b)] =
sum_b 2^b sum_g T_g[idx_g(b)]. K = 1 is a lane a group. The lanes of each
(set, window) are tree-reduced over the slices of each chunk (2^14 points,
and a ragged rest rounded up to a power of two, combined as
``msm._combine_partials``, baby_plonk_tpu/ops/msm.py:101-116); the W window
sums are joined by a Horner over the windows, S doublings and an addition
each. W = 1 is the unsplit loop of the JAX package. The launch is sized to
the scalars: groups past the longest scalar set are not run. W and K come
from the launch's shape: windows where the lanes do not fill the card,
groups a lane where they overfill it (``windows_for``,
``groups_per_lane``).

Kernels (csrc/msm_fixed.cu): ``build_tables`` (build, one inversion a
group, normalization; counterpart of ``_build_tables``,
ops/msm_fixed.py:82-131),
``msm_fixed_horner`` (counterpart of ``msm_fixed_pallas``,
ops/pallas_kernels.py:242, and its XLA twin ``_msm_fixed_kernel_oh``,
ops/msm_fixed.py:197-228) and ``msm_join``. Each sits beside its plain
version.
"""
from __future__ import annotations

import torch

from ..utils.metrics import get_metrics
from . import g1_vec, kernels, limbs, srs

FQ = limbs.FQ

GROUP = 8
NB = 1 << GROUP
#: points per chunk (the JAX package's CHUNK)
CHUNK = 1 << 14
#: Horner steps: bit 254 down to 0 (bit 255 of a canonical Fr scalar is 0)
NBITS = 255
#: 32-bit words of one packed table entry (x, then y)
ENTRY = 24
#: most windows a commit is cut into
MAX_WINDOWS = 16
#: lanes the Horner kernel keeps resident on one SM: 3 blocks of 128 threads
#: at its 167 registers a thread (__launch_bounds__(128, 3) in csrc/msm_fixed.cu)
LANES_PER_SM = 384
#: lanes the Horner kernel keeps resident on one SM where a lane sums K > 1
#: groups: 2 blocks of 128 at its 232 registers (__launch_bounds__(128, 2);
#: held to 3 blocks, it spills and runs 10-20% slower)
SLICED_LANES_PER_SM = 256
#: most groups one Horner lane sums at a bit (its step indices take 2 KB of a
#: block's shared memory a group: 32 KB at 16)
MAX_LANE_GROUPS = 16


def _pow2_ceil(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


# -- table layout -----------------------------------------------------------------


def pack_tables(tx, ty):
    """(24, G, 256) x2 limb arrays -> packed (G, 256, 24) int32 words."""
    words = []
    for t in (tx, ty):
        t = t.to(torch.int64)
        words.append(t[0::2] | (t[1::2] << 16))  # (12, G, 256)
    w = torch.cat(words, dim=0).permute(1, 2, 0)
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)  # the bit pattern as int32
    return w.to(torch.int32).contiguous()


def unpack_tables(packed):
    """Packed (G, 256, 24) words -> (tx, ty), (24, G, 256) int32 limb arrays
    (the JAX package's table layout)."""
    w = packed.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(*w.shape[:-1], 2 * ENTRY)
    limbs = limbs.movedim(-1, 0).to(torch.int32)  # (48, ...)
    return limbs[:24].contiguous(), limbs[24:].contiguous()


# -- table build ----------------------------------------------------------------


#: groups the plain build adds at a time and inverts at a time. A plain
#: product holds about 14 KB a lane at its widest: the last level's 6
#: stacked products over 128 x 1024 lanes take 11 GB, an inversion over 256
#: x 4096 lanes 15 GB. Each inversion's power is one serial chain of 570
#: products (chip_smoke's plain Fq power: about a second on the card), so
#: the inversions are the wider ones.
PLAIN_GROUPS, INVERT_GROUPS = 1024, 4096


def build_tables_plain(px, py, pz):
    """(24, 8G) x3 projective Montgomery -> packed affine tables
    (G, 256, 24). Level b appends entries [2^b, 2^(b+1)) = T[idx - 2^b] + P_b;
    then one inversion a group (``limbs.batch_inverse`` along the group's
    256 Z's), the identity (Z = 0) giving the (0, 0) marker."""
    G = px.shape[-1] // GROUP
    if G == 0:
        return torch.empty((0, NB, ENTRY), dtype=torch.int32, device=px.device)
    pts = tuple(c.to(torch.int64).reshape(24, G, GROUP) for c in (px, py, pz))
    parts = []
    for lo in range(0, G, PLAIN_GROUPS):
        part = tuple(c[:, lo : lo + PLAIN_GROUPS] for c in pts)
        g = part[0].shape[1]
        T = g1_vec.pidentity((g, 1), px.device, torch.int64)
        for b in range(GROUP):
            pb = tuple(c[:, :, b : b + 1].expand(24, g, 1 << b) for c in part)
            T = tuple(torch.cat([t, n], dim=-1) for t, n in zip(T, g1_vec.padd_plain(T, pb)))
        parts.append(T)
    X, Y, Z = (torch.cat(c, dim=1) for c in zip(*parts))
    out = []
    for s in (slice(lo, lo + INVERT_GROUPS) for lo in range(0, G, INVERT_GROUPS)):
        zinv = limbs.batch_inverse(FQ, Z[:, s], plain=True)
        out.append(pack_tables(*(limbs._mont_mul_plain(FQ, c[:, s], zinv) for c in (X, Y))))
    return torch.cat(out)


def build_tables(px, py, pz):
    """Packed subset-sum tables (G, 256, 24) of the 8-point groups of
    (24, 8G) x3 points. On the card three launches (csrc/msm_fixed.cu):
    the build, one thread a group for the group's one inversion, and the
    normalization; the scratch holds every entry's Z and each lane's
    segment product and its inverse."""
    if kernels.on_cpu(px, py, pz):
        return build_tables_plain(px, py, pz)
    dev = kernels.check_cuda(px, py, pz)
    n = px.shape[-1]
    if px.shape[0] != 24 or n % GROUP or any(c.shape != px.shape for c in (py, pz)):
        raise ValueError(f"build_tables: bad point shape {tuple(px.shape)}")
    G = n // GROUP
    px, py, pz = (c.contiguous() for c in (px, py, pz))
    packed = torch.empty((G, NB, ENTRY), dtype=torch.int32, device=dev)
    if G:
        zs = torch.empty((G, NB, 12), dtype=torch.int32, device=dev)
        seg = torch.empty((2, G, 32, 12), dtype=torch.int32, device=dev)
        kernels.launch("bpt_msm_build_tables", dev, *(kernels.ptr(c) for c in (px, py, pz)), G,
                       kernels.ptr(packed), kernels.ptr(zs), kernels.ptr(seg[0]), kernels.ptr(seg[1]))
        build_tables.launches += 1
    return packed


build_tables.launches = 0


# -- Horner loop ----------------------------------------------------------------


def window_bits(windows: int) -> int:
    """Bits of one window (the top one may hold fewer)."""
    if not 1 <= windows <= NBITS:
        raise ValueError(f"windows = {windows}: expected 1..{NBITS}")
    return -(-NBITS // windows)


def _sms(device) -> int:
    """Multiprocessors of the card; 0 on the CPU, where nothing runs side
    by side."""
    device = torch.device(device)
    return torch.cuda.get_device_properties(device).multi_processor_count if device.type == "cuda" else 0


def windows_for(lanes: int, device) -> int:
    """Windows for a commit of ``lanes`` = sets x groups lanes: doubled until
    the card's resident lanes are filled once, at most ``MAX_WINDOWS``. On
    the CPU one window."""
    resident = _sms(device) * LANES_PER_SM
    if not resident:
        return 1
    w = 1
    while w < MAX_WINDOWS and lanes * w * 2 <= resident:
        w *= 2
    return w


def lane_groups_for(lanes: int, sms: int) -> int:
    """Groups a lane for ``lanes`` = sets x groups on ``sms`` multiprocessors:
    1 where they fit the resident lanes at once (``windows_for`` then splits
    the bits instead, or there is nothing to gain); over them, the K that
    makes the fewest whole waves of the K > 1 kernel's resident lanes
    (``SLICED_LANES_PER_SM``) times one lane's work a step, a doubling and
    K mixed additions (the first such K)."""
    from ..utils.roofline import DOUBLE_MADS, FQ_MUL, MIXED_MULS

    if not sms or lanes <= sms * LANES_PER_SM:
        return 1
    wave = sms * SLICED_LANES_PER_SM
    return min(range(2, MAX_LANE_GROUPS + 1),
               key=lambda k: -(-lanes // (k * wave)) * (DOUBLE_MADS + k * FQ_MUL * MIXED_MULS))


def groups_per_lane(sets: int, groups: int, device) -> int:
    """K, the groups one Horner lane sums at a bit, for a launch of ``sets``
    scalar sets over ``groups`` groups (``lane_groups_for`` the card). 1 on
    the CPU."""
    return lane_groups_for(sets * groups, _sms(device))


def lane_slots(groups: int, lane_groups: int, chunk_groups: int) -> tuple[int, int]:
    """(slots of a whole chunk, slots of the rest) of a launch over ``groups``
    groups in chunks of ``chunk_groups``: a chunk of m groups, and the rest,
    has M = ceil(m / K) slices, K = ``lane_groups``, one lane a slice; slice
    s holds the chunk's groups s, s + M, s + 2 M, ... (at most K). Where
    K > 1 the slots of a chunk are its slices rounded up to a power of two,
    so that the group tree halves them; a slot past the slices holds the
    identity. At K = 1 a slot is a group."""
    full, rest = divmod(groups, chunk_groups)
    fit = (lambda m: m) if lane_groups == 1 else _pow2_ceil
    return fit(-(-chunk_groups // lane_groups)), fit(-(-rest // lane_groups)) if rest else 0


def _slot_groups(groups: int, lane_groups: int, chunk_groups: int, device):
    """(first group, groups, stride between them) of every lane slot, (L,)
    int64 each; 0 groups on a slot past its chunk's slices."""
    per_chunk, rest_slots = lane_slots(groups, lane_groups, chunk_groups)
    full = groups // chunk_groups
    slot = torch.arange(full * per_chunk + rest_slots, device=device)
    chunk = torch.clamp(slot // per_chunk, max=full)
    s = slot - chunk * per_chunk
    m = torch.clamp(groups - chunk * chunk_groups, max=chunk_groups)  # the chunk's groups
    stride = -(-m // lane_groups)
    count = torch.where(s < stride, -(-(m - s) // stride), 0)
    return chunk * chunk_groups + s, count, stride


def _lanes_run(groups: int, lane_groups: int, chunk_groups: int) -> int:
    """Lanes of a (set, window): the slots that hold at least one group."""
    full, rest = divmod(groups, chunk_groups)
    return full * -(-chunk_groups // lane_groups) + -(-rest // lane_groups)


def _table_index(scalars, bit: int):
    """(16, P, 8G) raw limbs -> (P, G) 8-bit table index of ``bit`` (0 for
    a bit past the scalars' 255)."""
    P, n = scalars.shape[1], scalars.shape[2]
    if bit >= NBITS:
        return torch.zeros((P, n // GROUP), dtype=scalars.dtype, device=scalars.device)
    b = (scalars[bit >> 4].reshape(P, n // GROUP, GROUP) >> (bit & 15)) & 1
    shifts = torch.arange(GROUP, device=scalars.device)
    return (b << shifts).sum(-1)


def _entry_limbs(packed, groups, idx):
    """Entries ``idx`` (P, W, L) of groups ``groups`` (L,) -> (qx, qy),
    (24, P, W, L) int64 limbs."""
    w = packed[groups, idx].to(torch.int64) & 0xFFFFFFFF  # (P, W, L, 24)
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(*idx.shape, 2 * ENTRY).movedim(-1, 0)
    return limbs[:24], limbs[24:]


def msm_fixed_plain(packed, scalars, windows: int = 1, lane_groups: int = 1, chunk_groups: int | None = None):
    """Plain windowed Horner loop: packed tables (Gt, 256, 24), scalars
    (16, P, 8G) raw, G <= Gt -> per-lane projective partials (24, P, W, L),
    int64, L the ``lane_slots`` of G groups in chunks of ``chunk_groups``
    (default G) at K = ``lane_groups``. Lane (p, w, slot) runs bits
    [w S, min((w + 1) S, 255)), MSB first: a doubling, then the entries of
    its slice's groups in their order, the (0, 0) marker skipped. A step
    past bit 254 doubles the identity, which leaves it limb for limb."""
    S = window_bits(windows)
    P, G = scalars.shape[1], scalars.shape[2] // GROUP
    first, count, stride = _slot_groups(G, lane_groups, chunk_groups or max(G, 1), packed.device)
    sc = scalars.to(torch.int64)
    acc = g1_vec.pidentity((P, windows, first.shape[0]), packed.device, torch.int64)
    for s in range(S - 1, -1, -1):
        idx = torch.stack([_table_index(sc, w * S + s) for w in range(windows)], dim=1)  # (P, W, G)
        acc = g1_vec.pdouble_plain(acc)
        for k in range(lane_groups):
            g = torch.clamp(first + k * stride, max=G - 1)
            qx, qy = _entry_limbs(packed, g, idx[..., g])
            added = g1_vec.padd_mixed_plain(acc, qx, qy)
            skip = ((qx == 0).all(0) & (qy == 0).all(0)) | (count <= k)  # (0, 0) = identity
            acc = g1_vec.pselect(skip, acc, added)
    return acc


def msm_fixed_horner(packed, scalars, windows: int = 1, lane_groups: int | None = None,
                     chunk_groups: int | None = None):
    """Per-lane Horner partials (24, P, W, L) of P scalar sets (16, P, 8G)
    against the first G groups of the packed tables, in W = ``windows``
    windows of ``window_bits(W)`` bits, a lane summing K = ``lane_groups``
    groups of a chunk of ``chunk_groups`` (default G) at a bit; L is
    ``lane_slots``' count. K defaults to ``groups_per_lane``, which is 1
    wherever ``windows_for`` splits the bits. Counts ``horner_groups`` (P G)
    and ``horner_lanes`` (the lanes)."""
    S = window_bits(windows)
    P, n = scalars.shape[1], scalars.shape[2]
    G = n // GROUP
    gc = chunk_groups or max(G, 1)
    K = lane_groups or groups_per_lane(P, G, scalars.device)
    if not 1 <= K <= MAX_LANE_GROUPS:
        raise ValueError(f"msm_fixed_horner: {K} groups a lane, expected 1..{MAX_LANE_GROUPS}")
    if P * G:
        m = get_metrics()
        m.count("horner_groups", P * G)
        m.count("horner_lanes", P * windows * _lanes_run(G, K, gc))
    if kernels.on_cpu(packed, scalars):
        return tuple(c.to(torch.int32) for c in msm_fixed_plain(packed, scalars, windows, K, gc))
    dev = kernels.check_cuda(packed, scalars)
    Gt = packed.shape[0]
    if packed.shape != (Gt, NB, ENTRY) or scalars.shape[0] != 16 or n % GROUP or G > Gt:
        raise ValueError("msm_fixed_horner: bad table or scalar shape")
    packed, scalars = packed.contiguous(), scalars.contiguous()
    per_chunk, rest = lane_slots(G, K, gc)
    L = G // gc * per_chunk + rest
    out = tuple(torch.empty((24, P, windows, L), dtype=torch.int32, device=dev) for _ in range(3))
    if P * G:
        kernels.launch("bpt_msm_fixed", dev, kernels.ptr(packed), kernels.ptr(scalars), P, G, windows, S, K, gc,
                       per_chunk, L, *(kernels.ptr(c) for c in out))
        msm_fixed_horner.launches += 1
    return out


msm_fixed_horner.launches = 0


# -- join of the windows ----------------------------------------------------------


def msm_join_plain(win, S: int):
    """Plain version of ``msm_join``: (24, P, W) x3 window sums ->
    sum_w 2^(w S) window_w, (24, P) x3 int64, from the top window down."""
    win = g1_vec._to64(win)
    W = win[0].shape[-1]
    acc = tuple(c[..., W - 1] for c in win)
    for w in range(W - 2, -1, -1):
        for _ in range(S):
            acc = g1_vec.pdouble_plain(acc)
        acc = g1_vec.padd_plain(acc, tuple(c[..., w] for c in win))
    return acc


def msm_join(win, S: int):
    """Join the window sums (24, P, W) x3 of windows of S bits: (24, P) x3."""
    if kernels.on_cpu(*win):
        return g1_vec._to32(msm_join_plain(win, S))
    dev = kernels.check_cuda(*win)
    _, P, W = win[0].shape
    if win[0].shape[0] != 24 or any(c.shape != win[0].shape for c in win) or S < 1:
        raise ValueError("msm_join: window sums must be (24, P, W) x3")
    win = tuple(c.contiguous() for c in win)
    out = tuple(torch.empty((24, P), dtype=torch.int32, device=dev) for _ in range(3))
    if P:
        kernels.launch("bpt_msm_join", dev, *(kernels.ptr(c) for c in win), P, W, S,
                       *(kernels.ptr(c) for c in out))
        msm_join.launches += 1
    return out


msm_join.launches = 0


# -- per-SRS tables -------------------------------------------------------------


class FixedBaseTables:
    """Subset-sum tables over a fixed point set (24, n) x3. The groups are
    summed in chunks of ``chunk`` points and a ragged rest, rounded up to a
    power of two of groups; the tables cover the same rounding (the filling
    points are copies of point 0 and only ever see zero scalar bits). The
    tables are built at the first MSM."""

    def __init__(self, points, chunk: int = CHUNK):
        self.points = points
        self.n = points[0].shape[-1]
        assert chunk % GROUP == 0 and (chunk // GROUP) & (chunk // GROUP - 1) == 0
        self.chunk = chunk
        self._tables = None

    def launch_groups(self, k: int) -> tuple[int, int]:
        """(whole chunks, groups of the rest rounded up to a power of two)
        that hold the first ``k`` points."""
        gc = self.chunk // GROUP
        groups = max(-(-k // GROUP), 1)
        full, rest = divmod(groups, gc)
        return full, _pow2_ceil(rest) if rest else 0

    def tables(self):
        if self._tables is None:
            full, rest = self.launch_groups(self.n)
            pad = (full * (self.chunk // GROUP) + rest) * GROUP - self.n
            self._tables = build_tables(*(
                torch.cat([c, c[:, :1].expand(24, pad)], dim=-1) for c in self.points
            ))
        return self._tables

    def msm_many(self, scalars_list, windows: int | None = None, per_chunk: bool = False):
        """MSMs of several raw scalar arrays (16, k_i), k_i <= n, against the
        first k_i points. ``windows``: the split of the 255 bits (default:
        ``windows_for`` the launch). Returns (X, Y, Z) of shape (24, P), or
        with ``per_chunk`` the sum of each chunk of points apart, (24, P, C)
        (the mesh's shards that share a device, one chunk a shard)."""
        P = len(scalars_list)
        k = max(s.shape[-1] for s in scalars_list)
        assert k <= self.n, (k, self.n)
        gc = self.chunk // GROUP
        full, rest = self.launch_groups(k)
        G = full * gc + rest
        dev = self.points[0].device
        W = windows_for(P * G, dev) if windows is None else windows
        K = groups_per_lane(P, G, dev)
        sc = torch.zeros((16, P, G * GROUP), dtype=torch.int32, device=dev)
        for i, s in enumerate(scalars_list):
            sc[:, i, : s.shape[-1]] = s
        part = msm_fixed_horner(self.tables(), sc, W, K, gc)  # (24, P, W, L)
        slots = lane_slots(G, K, gc)[0]  # a whole chunk's
        sums = []
        if full:
            whole = tuple(c[..., : full * slots].reshape(24, P, W, full, slots) for c in part)
            sums.append(g1_vec.tree_reduce(whole))
        if rest:
            tail = g1_vec.tree_reduce(tuple(c[..., full * slots :] for c in part))
            sums.append(tuple(c.unsqueeze(-1) for c in tail))
        chunks = tuple(torch.cat(cs, dim=-1) for cs in zip(*sums))  # (24, P, W, C)
        C = chunks[0].shape[-1]
        if per_chunk:  # each chunk joined apart: P C sets of W window sums
            win = tuple(c.movedim(-1, -2).reshape(24, P * C, W) for c in chunks)
        else:
            win = g1_vec.combine_partials(chunks)  # (24, P, W)
        out = tuple(c[..., 0] for c in win) if W == 1 else msm_join(win, window_bits(W))
        return tuple(c.reshape(24, P, C) for c in out) if per_chunk else out

    def msm(self, scalars, windows: int | None = None):
        return tuple(c[:, 0] for c in self.msm_many([scalars], windows))


def tables_for_setup(setup, device) -> FixedBaseTables:
    """Per-setup, per-device cached tables over the SRS (chunk = the next
    power of two >= min(n, CHUNK), as ``msm_fixed.tables_for_setup``)."""
    cache = setup.fb_tables
    key = str(device)
    tabs = cache.get(key)
    if tabs is None:
        pts = srs.setup_points(setup, device)
        n = pts[0].shape[-1]
        c = GROUP
        while c < min(n, CHUNK):
            c <<= 1
        tabs = cache[key] = FixedBaseTables(pts, chunk=c)
    return tabs
