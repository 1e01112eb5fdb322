"""Powers of tau on the device: the G1 half of the KZG SRS, column i =
tau^i * G (counterpart of ``baby_plonk_tpu/ops/srs.py``:
``_fixed_base_kernel`` :23-41, ``powers_of_tau_device`` :49-82 and
``powers_of_tau_sharded`` :85-114).

The scalars tau^i are host field multiplies. A lane's scalar multiple is
fixed-base windowing over a table of the base's multiples, kept per
(device, base) in ``base_tables``: entry [k][d] = d 2^(8k) base, the
subset-sum tables (``msm_fixed.build_tables``) of the doubling chain
2^i base, i < 256 (``doubling_chain``). A lane then adds one entry for each
nonzero byte of its scalar, 32 windows and no doubling (csrc/srs.cu), where
the reference doubles the same base 254 times in every lane. The points
are the reference's as group elements (equal affine coordinates); their
projective coordinates differ. A host-Python SRS costs milliseconds per
point, minutes at 2^16 points.
"""
from __future__ import annotations

import torch

from ..fields import fr

from . import g1_vec, kernels, limbs

#: windows of a scalar, one a byte (the top one keeps bits 248-254: bit 255
#: is past the reference's 255 bits), and points 2^i base of the doubling
#: chain that the table is built from
WINDOWS, CHAIN = 32, 256

#: the table of multiples of each base, by (device, base limbs)
base_tables: dict = {}


def doubling_chain_plain(base):
    """Plain version of ``doubling_chain``, int64."""
    p = tuple(base[:, i : i + 1].to(torch.int64) for i in range(3))
    cols = [p]
    for _ in range(CHAIN - 1):
        cols.append(g1_vec.pdouble_plain(cols[-1]))
    return tuple(torch.cat([c[k] for c in cols], dim=1) for k in range(3))


def doubling_chain(base):
    """(24, 3) base (X, Y, Z columns, Montgomery) -> (24, 256) x3, column i
    = 2^i base. On the card 255 launches of the one-point doubling kernel
    (csrc/g1.cu, counted in ``g1_vec.pdouble.launches``), launch i reading
    row i - 1 of one point-major (3, 256, 24) buffer and writing row i: a
    step costs the host one launch and nothing else. The buffer's two
    layout moves (the base in, the limb-major chain out, 73 KB) go through
    host memory: on the card each would be a strided copy, and the first
    strided copy of a process loads torch's copy kernel, tens of ms."""
    if base.shape != (24, 3):
        raise ValueError(f"doubling_chain: base of shape {tuple(base.shape)}, expected (24, 3)")
    if kernels.on_cpu(base):
        return g1_vec._to32(doubling_chain_plain(base))
    dev = kernels.check_cuda(base)
    host = torch.zeros((3, CHAIN, 24), dtype=torch.int32)
    host[:, 0] = limbs.to_host(base).T
    buf = limbs.to_device(host, dev)
    rows = [kernels.ptr(buf[c]) for c in range(3)]
    step = 24 * buf.element_size()
    for i in range(1, CHAIN):
        kernels.launch("bpt_g1_pdouble", dev, *(r + (i - 1) * step for r in rows), *(r + i * step for r in rows), 1)
        g1_vec.pdouble.launches += 1
    return tuple(limbs.to_device(limbs.to_host(buf).transpose(1, 2).contiguous(), dev))


def base_table(base):
    """The table of ``base``'s multiples on its device, (32, 256, 24) packed
    affine (``msm_fixed``'s layout), entry [k][d] = d 2^(8k) base: built at
    the first call for this (device, base), then kept in ``base_tables``."""
    from . import msm_fixed  # msm_fixed imports this module

    key = (str(base.device), tuple(limbs.to_host(base.flatten()).tolist()))
    table = base_tables.get(key)
    if table is None:
        table = base_tables[key] = msm_fixed.build_tables(*doubling_chain(base))
    return table


def _digit(scalars, k: int):
    """Byte k of each raw scalar (16, n) -> (n,)."""
    d = (scalars[k >> 1] >> (8 * (k & 1))) & 0xFF
    return d & 0x7F if k == WINDOWS - 1 else d


def powers_of_tau_plain(scalars, base, table=None):
    """Plain version: scalars (16, n) raw, base (24, 3) Montgomery (X, Y, Z
    columns) -> (24, n) x3, int64: the kernel's windows in its order, a
    mixed addition of entry [k][byte k] where the byte is not 0. ``table``:
    the base's table of multiples, else built here by the plain versions."""
    from . import msm_fixed

    if table is None:
        table = msm_fixed.build_tables_plain(*doubling_chain_plain(base))
    n = scalars.shape[-1]
    sc = scalars.to(torch.int64)
    acc = g1_vec.pidentity((n,), scalars.device, torch.int64)
    for k in range(WINDOWS):
        d = _digit(sc, k)
        qx, qy = (c.to(torch.int64) for c in msm_fixed.unpack_tables(table[k, d]))
        acc = g1_vec.pselect(d != 0, g1_vec.padd_mixed_plain(acc, qx, qy), acc)
    return acc


def powers_of_tau(scalars, base):
    """Per-lane scalar multiples scalars[:, i] * base, (24, n) x3."""
    if base.shape != (24, 3) or scalars.shape[0] != 16:
        raise ValueError("powers_of_tau: bad shapes")
    table = base_table(base)
    if kernels.on_cpu(scalars, table):
        return g1_vec._to32(powers_of_tau_plain(scalars, base, table))
    dev = kernels.check_cuda(scalars, table)
    n = scalars.shape[-1]
    scalars = scalars.contiguous()
    out = tuple(torch.empty((24, n), dtype=torch.int32, device=dev) for _ in range(3))
    if n:
        kernels.launch("bpt_powers_of_tau", dev, kernels.ptr(scalars), kernels.ptr(table), n,
                       *(kernels.ptr(c) for c in out))
        powers_of_tau.launches += 1
    return out


powers_of_tau.launches = 0


def generator_base(device) -> torch.Tensor:
    """(24, 3): the G1 generator's projective Montgomery X, Y, Z columns."""
    from ..curves.g1 import G1

    return torch.cat(g1_vec.points_to_device([G1.generator()], device), dim=1)


def tau_scalars(powers: int, tau: int, device) -> torch.Tensor:
    tau %= fr.Q
    cur, out = 1, []
    for _ in range(powers):
        out.append(cur)
        cur = cur * tau % fr.Q
    return limbs.FR.pack_raw(out, device)


def powers_of_tau_device(powers: int, tau: int, device):
    """(X, Y, Z) (24, powers) with column i = tau^i * G."""
    return powers_of_tau(tau_scalars(powers, tau, device), generator_base(device))


def setup_points(setup, device):
    """The setup's G1 powers on ``device`` as (24, n) x3 Montgomery
    projective tensors, cached in its ``device_points``: the device SRS
    made by ``Setup.generate_srs_device``, or the host ``powers_of_x`` uploaded
    once."""
    cache = setup.device_points
    key = str(device)
    pts = cache.get(key)
    if pts is None:
        if cache:  # made on another device: copy the tensors over
            pts = tuple(c.to(device) for c in next(iter(cache.values())))
        elif setup.powers_of_x is not None:
            pts = g1_vec.points_to_device(setup.powers_of_x, device)
        else:
            raise ValueError("setup has neither host powers nor a port device SRS")
        cache[key] = pts
    return pts


def powers_of_tau_sharded(powers: int, tau: int, mesh):
    """The powers of tau block-sharded over a mesh (counterpart of
    ``baby_plonk_tpu/ops/srs.py::powers_of_tau_sharded``): the kernel is
    lane-wise, so each shard computes its own block of tau^i G with no
    collective. ``powers`` is padded up to a multiple of the shard count
    with zero scalars (the identity). Returns one (X, Y, Z) of (24, N/D)
    a shard."""
    N = -(-powers // mesh.D) * mesh.D
    scalars = tau_scalars(powers, tau, mesh.home)
    scalars = torch.cat([scalars, scalars.new_zeros((16, N - powers))], dim=-1)
    base = generator_base(mesh.home)
    return [powers_of_tau(sc, base.to(sc.device)) for sc in mesh.shard(scalars)]
