"""Radix-2 NTT over the 2-adic subgroup of Fr for the port.

Computes the same function as ``baby_plonk_tpu/ops/ntt.py::ntt_device``
(forward X_j = sum_i x_i w^(ij), inverse with the 1/n scaling) on
Montgomery limbs (16, ..., n), position axis last. Every transform is the
four-step ``kernels.ntt_sub_4step`` (n = n1 x n2: on the card two launches
of the sub-NTT kernel with the cross twiddle, the bit reversal, the
transpose and the inverse's 1/n in its epilogue), whatever n: an NTT is one
function whatever the algorithm, so the JAX package's Pease path
(ntt.py:70-148) has no separate counterpart.

The plans are the JAX package's ``_plan4`` (ntt.py:173) rewritten in pure
Python (that module imports JAX when loaded); tables are packed once per
(n, direction, device).
"""
from __future__ import annotations

import functools

import torch

from ..fields import fr

from . import kernels, limbs

Q = fr.Q


def bit_reverse_perm(n: int) -> list[int]:
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]


def _root(n: int, inverse: bool) -> int:
    root = fr.root_of_unity(n) if n > 1 else 1
    return pow(root, Q - 2, Q) if inverse else root


def _powers(w: int, count: int) -> list[int]:
    out = [1] * count
    for i in range(1, count):
        out[i] = out[i - 1] * w % Q
    return out


@functools.lru_cache(maxsize=None)
def _sub_twiddles(m: int, inverse: bool, device: str) -> torch.Tensor:
    return limbs.FR.pack_mont(_powers(_root(m, inverse), max(m // 2, 1)), device)


def sub_twiddles(m: int, inverse: bool, device) -> torch.Tensor:
    """(16, m/2) Montgomery powers w^k of the primitive m-th root (its
    inverse for ``inverse``): the sub-NTT kernel's twiddle table."""
    return _sub_twiddles(m, inverse, str(device))


@functools.lru_cache(maxsize=None)
def _stage_twiddles(m: int, inverse: bool, device: str) -> torch.Tensor:
    pw = _sub_twiddles(m, inverse, device)
    stages, length = [], m // 2
    while length >= 1:
        stages.append(pw[:, :: m // (2 * length)])
        length //= 2
    return torch.cat(stages, dim=-1).contiguous()


def stage_twiddles(m: int, inverse: bool, device) -> torch.Tensor:
    """(16, m - 1): the sub-NTT kernel's twiddles laid out stage by stage.
    The stage of half length len = m/2, m/4, ..., 1 holds w^(off m / (2 len)),
    off < len, at columns m - 2 len onwards, so a warp reads them contiguous."""
    return _stage_twiddles(m, inverse, str(device))


def split(n: int) -> tuple[int, int]:
    """n = n1 * n2 with n2 the larger factor (ops/ntt.py::_plan4)."""
    logn = n.bit_length() - 1
    log_n2 = (logn + 1) // 2
    return 1 << (logn - log_n2), 1 << log_n2


@functools.lru_cache(maxsize=None)
def _plan4(n: int, inverse: bool, device: str, scaled: bool):
    n1, n2 = split(n)
    root = _root(n, inverse)
    base_row = _powers(root, n2)  # w^i2
    first = pow(n, Q - 2, Q) if scaled and inverse else 1
    cross = [first] * n  # row j1 holds w^(j1 * i2), times 1/n where scaled
    for j1 in range(1, n1):
        row, prev = j1 * n2, (j1 - 1) * n2
        for i2 in range(n2):
            cross[row + i2] = cross[prev + i2] * base_row[i2] % Q
    crossT = limbs.FR.pack_mont(cross, device).reshape(16, n1, n2)
    br1 = limbs.to_device(torch.tensor(bit_reverse_perm(n1), dtype=torch.int64), device)
    br2 = limbs.to_device(torch.tensor(bit_reverse_perm(n2), dtype=torch.int64), device)
    return n1, n2, crossT, br1, br2


def plan4(n: int, inverse: bool, device, scaled: bool = False):
    """(n1, n2, crossT (16, n1, n2) Montgomery, br1, br2) for the four-step
    split of a length-n transform. ``scaled``: the inverse plan's cross
    twiddles carry the 1/n of the inverse transform, w^-(j1 i2) / n, so that
    the scaling costs no pass of its own."""
    return _plan4(n, inverse, str(device), bool(scaled and inverse))


def ntt_device(a: torch.Tensor, inverse: bool = False, plain: bool = False) -> torch.Tensor:
    """NTT of Montgomery Fr limbs (16, ..., n) along the last axis, natural
    order in and out; the inverse includes the 1/n scaling (in the plan's
    cross twiddles). ``plain`` runs the plain versions whatever the device
    (the reference on the card)."""
    n = a.shape[-1]
    if n == 1:
        return a
    K = a[0].numel() // n
    return kernels.ntt_sub_4step(a.reshape(16, K, n, 1), inverse, plain=plain, scaled=True).reshape(a.shape)


def ntt_ints(values: list[int], inverse: bool = False, *, device) -> list[int]:
    """list[int] -> list[int] through ``ntt_device`` on ``device``."""
    a = limbs.FR.pack_mont(values, device)
    return limbs.FR.unpack_mont(ntt_device(a, inverse))
