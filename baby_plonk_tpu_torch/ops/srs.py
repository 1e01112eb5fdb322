"""Powers of tau on the device: the G1 half of the KZG SRS, column i =
tau^i * G (counterpart of ``baby_plonk_tpu/ops/srs.py``:
``_fixed_base_kernel`` :23-41 and ``powers_of_tau_device`` :49-82).

The scalars tau^i are host field multiplies; the 255-step double-and-add
of every lane is the kernel ``bpt_powers_of_tau`` (csrc/srs.cu). A
host-Python SRS costs milliseconds per point, minutes at 2^16 points.
"""
from __future__ import annotations

import torch

from ..fields import fr

from . import g1_vec, kernels, limbs

NBITS = 255


def powers_of_tau_plain(scalars, base):
    """Plain version: scalars (16, n) raw, base (24, 3) Montgomery (X, Y, Z
    columns) -> (24, n) x3, LSB-first double-and-add, int64."""
    n = scalars.shape[-1]
    sc = scalars.to(torch.int64)
    b = tuple(base[:, i : i + 1].to(torch.int64).expand(24, n) for i in range(3))
    acc = g1_vec.pidentity((n,), scalars.device, torch.int64)
    for bit in range(NBITS):
        set_ = ((sc[bit >> 4] >> (bit & 15)) & 1) == 1
        acc = g1_vec.pselect(set_, g1_vec.padd_plain(acc, b), acc)
        b = g1_vec.pdouble_plain(b)
    return acc


def powers_of_tau(scalars, base):
    """Per-lane scalar multiples scalars[:, i] * base, (24, n) x3."""
    if kernels.on_cpu(scalars, base):
        return tuple(c.to(torch.int32) for c in powers_of_tau_plain(scalars, base))
    dev = kernels.check_cuda(scalars, base)
    if scalars.shape[0] != 16 or base.shape != (24, 3):
        raise ValueError("powers_of_tau: bad shapes")
    n = scalars.shape[-1]
    scalars, base = scalars.contiguous(), base.contiguous()
    out = tuple(torch.empty((24, n), dtype=torch.int32, device=dev) for _ in range(3))
    if n:
        kernels.launch("bpt_powers_of_tau", kernels.ptr(scalars), kernels.ptr(base), n,
                       *(kernels.ptr(c) for c in out), kernels.stream(dev))
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
