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
A lane is (scalar set, window, group) and runs its window's Horner steps,
MSB first, acc = 2 acc + T[g][bits of the group's 8 scalars]; the lanes of
each (set, window) are tree-reduced over the groups (2^14-point chunks, and
a ragged rest rounded up to a power of two, combined as
``msm._combine_partials``, baby_plonk_tpu/ops/msm.py:101-116); the W window
sums are joined by a Horner over the windows, S doublings and an addition
each. W = 1 is the unsplit loop of the JAX package. The launch is sized to
the scalars: groups past the longest scalar set are not run.

Kernels (csrc/msm_fixed.cu): ``build_tables`` (build + normalization,
counterpart of ``_build_tables``, ops/msm_fixed.py:82-131),
``msm_fixed_horner`` (counterpart of ``msm_fixed_pallas``,
ops/pallas_kernels.py:242, and its XLA twin ``_msm_fixed_kernel_oh``,
ops/msm_fixed.py:197-228) and ``msm_join``. Each sits beside its plain
version.
"""
from __future__ import annotations

import torch

from . import g1_vec, kernels, srs

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


def build_tables_plain(px, py, pz):
    """(24, 8G) x3 projective Montgomery -> packed affine tables
    (G, 256, 24). Level b appends entries [2^b, 2^(b+1)) = T[idx - 2^b] + P_b."""
    G = px.shape[-1] // GROUP
    pts = tuple(c.to(torch.int64).reshape(24, G, GROUP) for c in (px, py, pz))
    T = g1_vec.pidentity((G, 1), px.device, torch.int64)
    for b in range(GROUP):
        width = 1 << b
        pb = tuple(c[:, :, b : b + 1].expand(24, G, width) for c in pts)
        new = g1_vec.padd_plain(T, pb)
        T = tuple(torch.cat([t, n], dim=-1) for t, n in zip(T, new))
    return pack_tables(*g1_vec.batch_normalize(T, plain=True))


def build_tables(px, py, pz):
    """Packed subset-sum tables (G, 256, 24) of the 8-point groups of
    (24, 8G) x3 points."""
    if kernels.on_cpu(px, py, pz):
        return build_tables_plain(px, py, pz)
    dev = kernels.check_cuda(px, py, pz)
    n = px.shape[-1]
    if px.shape[0] != 24 or n % GROUP or any(c.shape != px.shape for c in (py, pz)):
        raise ValueError(f"build_tables: bad point shape {tuple(px.shape)}")
    G = n // GROUP
    px, py, pz = (c.contiguous() for c in (px, py, pz))
    scratch = tuple(torch.empty((24, G, NB), dtype=torch.int32, device=dev) for _ in range(3))
    packed = torch.empty((G, NB, ENTRY), dtype=torch.int32, device=dev)
    kernels.launch("bpt_msm_build_tables", dev, *(kernels.ptr(c) for c in (px, py, pz)), G,
                   *(kernels.ptr(c) for c in scratch))
    kernels.launch("bpt_msm_normalize_tables", dev, *(kernels.ptr(c) for c in scratch), G, kernels.ptr(packed))
    build_tables.launches += 1
    return packed


build_tables.launches = 0


# -- Horner loop ----------------------------------------------------------------


def window_bits(windows: int) -> int:
    """Bits of one window (the top one may hold fewer)."""
    if not 1 <= windows <= NBITS:
        raise ValueError(f"windows = {windows}: expected 1..{NBITS}")
    return -(-NBITS // windows)


def windows_for(lanes: int, device) -> int:
    """Windows for a commit of ``lanes`` = sets x groups lanes: doubled until
    the card's resident lanes are filled once, at most ``MAX_WINDOWS``. On
    the CPU nothing runs side by side: one window."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    resident = torch.cuda.get_device_properties(device).multi_processor_count * LANES_PER_SM
    w = 1
    while w < MAX_WINDOWS and lanes * w * 2 <= resident:
        w *= 2
    return w


def _table_index(scalars, bit: int):
    """(16, P, 8G) raw limbs -> (P, G) 8-bit table index of ``bit`` (0 for
    a bit past the scalars' 255)."""
    P, n = scalars.shape[1], scalars.shape[2]
    if bit >= NBITS:
        return torch.zeros((P, n // GROUP), dtype=scalars.dtype, device=scalars.device)
    b = (scalars[bit >> 4].reshape(P, n // GROUP, GROUP) >> (bit & 15)) & 1
    shifts = torch.arange(GROUP, device=scalars.device)
    return (b << shifts).sum(-1)


def _entry_limbs(packed, idx):
    """Entries ``idx`` (P, W, G) of groups 0..G-1 -> (qx, qy), (24, P, W, G)
    int64 limbs."""
    G = idx.shape[-1]
    groups = torch.arange(G, device=packed.device)
    w = packed[groups, idx].to(torch.int64) & 0xFFFFFFFF  # (P, W, G, 24)
    limbs = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(*idx.shape, 2 * ENTRY).movedim(-1, 0)
    return limbs[:24], limbs[24:]


def msm_fixed_plain(packed, scalars, windows: int = 1):
    """Plain windowed Horner loop: packed tables (Gt, 256, 24), scalars
    (16, P, 8G) raw, G <= Gt -> per-lane projective partials (24, P, W, G),
    int64. Lane (p, w, g) runs bits [w S, min((w + 1) S, 255)), MSB first; a
    step past bit 254 doubles the identity, which leaves it limb for limb."""
    S = window_bits(windows)
    P, G = scalars.shape[1], scalars.shape[2] // GROUP
    sc = scalars.to(torch.int64)
    acc = g1_vec.pidentity((P, windows, G), packed.device, torch.int64)
    for s in range(S - 1, -1, -1):
        idx = torch.stack([_table_index(sc, w * S + s) for w in range(windows)], dim=1)
        qx, qy = _entry_limbs(packed, idx)
        acc = g1_vec.pdouble_plain(acc)
        added = g1_vec.padd_mixed_plain(acc, qx, qy)
        marker = (qx == 0).all(0) & (qy == 0).all(0)  # (0, 0) = identity
        acc = g1_vec.pselect(marker, acc, added)
    return acc


def msm_fixed_horner(packed, scalars, windows: int = 1):
    """Per-lane Horner partials (24, P, W, G) of P scalar sets (16, P, 8G)
    against the first G groups of the packed tables, in W = ``windows``
    windows of ``window_bits(W)`` bits."""
    S = window_bits(windows)
    if kernels.on_cpu(packed, scalars):
        return tuple(c.to(torch.int32) for c in msm_fixed_plain(packed, scalars, windows))
    dev = kernels.check_cuda(packed, scalars)
    Gt = packed.shape[0]
    P, n = scalars.shape[1], scalars.shape[2]
    G = n // GROUP
    if packed.shape != (Gt, NB, ENTRY) or scalars.shape[0] != 16 or n % GROUP or G > Gt:
        raise ValueError("msm_fixed_horner: bad table or scalar shape")
    packed, scalars = packed.contiguous(), scalars.contiguous()
    out = tuple(torch.empty((24, P, windows, G), dtype=torch.int32, device=dev) for _ in range(3))
    if P * G:
        kernels.launch("bpt_msm_fixed", dev, kernels.ptr(packed), kernels.ptr(scalars), P, G, windows, S,
                       *(kernels.ptr(c) for c in out))
        msm_fixed_horner.launches += 1
        msm_fixed_horner.lanes += P * windows * G
    return out


msm_fixed_horner.launches = 0
#: lanes (threads with a Horner loop) of all launches so far
msm_fixed_horner.lanes = 0


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
        sc = torch.zeros((16, P, G * GROUP), dtype=torch.int32, device=dev)
        for i, s in enumerate(scalars_list):
            sc[:, i, : s.shape[-1]] = s
        part = msm_fixed_horner(self.tables(), sc, W)  # (24, P, W, G)
        sums = []
        if full:
            whole = tuple(c[..., : full * gc].reshape(24, P, W, full, gc) for c in part)
            sums.append(g1_vec.tree_reduce(whole))
        if rest:
            tail = g1_vec.tree_reduce(tuple(c[..., full * gc :] for c in part))
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
