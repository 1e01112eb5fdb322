"""Radix-2 NTT over the 2-adic subgroup of Fr for the port.

Computes the same function as ``baby_plonk_tpu/ops/ntt.py::ntt_device``
(forward X_j = sum_i x_i w^(ij), inverse with the 1/n scaling) on
Montgomery limbs (16, ..., n), position axis last. Every transform is the
four-step composition ``kernels.ntt_sub_4step`` (n = n1 x n2, sub-NTT
kernels along the row axis, one cross-twiddle multiply and a transpose),
whatever n: an NTT is one function whatever the algorithm, so the JAX
package's Pease path (ntt.py:70-148) has no separate counterpart.

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


def split(n: int) -> tuple[int, int]:
    """n = n1 * n2 with n2 the larger factor (ops/ntt.py::_plan4)."""
    logn = n.bit_length() - 1
    log_n2 = (logn + 1) // 2
    return 1 << (logn - log_n2), 1 << log_n2


@functools.lru_cache(maxsize=None)
def _plan4(n: int, inverse: bool, device: str):
    n1, n2 = split(n)
    root = _root(n, inverse)
    base_row = _powers(root, n2)  # w^i2
    cross = [1] * n  # row j1 holds w^(j1 * i2)
    for j1 in range(1, n1):
        row, prev = j1 * n2, (j1 - 1) * n2
        for i2 in range(n2):
            cross[row + i2] = cross[prev + i2] * base_row[i2] % Q
    crossT = limbs.FR.pack_mont(cross, device).reshape(16, n1, n2)
    br1 = torch.tensor(bit_reverse_perm(n1), dtype=torch.int64, device=device)
    br2 = torch.tensor(bit_reverse_perm(n2), dtype=torch.int64, device=device)
    return n1, n2, crossT, br1, br2


def plan4(n: int, inverse: bool, device):
    """(n1, n2, crossT (16, n1, n2) Montgomery, br1, br2) for the four-step
    split of a length-n transform."""
    return _plan4(n, inverse, str(device))


def n_inv(n: int, device) -> torch.Tensor:
    return limbs.FR.mont_scalar(pow(n, Q - 2, Q), device)


def ntt_device(a: torch.Tensor, inverse: bool = False, plain: bool = False) -> torch.Tensor:
    """NTT of Montgomery Fr limbs (16, ..., n) along the last axis, natural
    order in and out; the inverse includes the 1/n scaling. ``plain`` runs
    the plain versions whatever the device (the reference on the card)."""
    n = a.shape[-1]
    if n == 1:
        return a
    K = a[0].numel() // n
    out = kernels.ntt_sub_4step(a.reshape(16, K, n, 1), inverse, plain=plain).reshape(a.shape)
    if inverse:
        if plain:
            out = limbs._mont_mul_plain(limbs.FR, out, n_inv(n, a.device)).to(torch.int32)
        else:
            out = limbs.mont_mul(limbs.FR, out, n_inv(n, a.device))
    return out


def ntt_ints(values: list[int], inverse: bool = False, device="cpu") -> list[int]:
    """list[int] -> list[int] through ``ntt_device``."""
    a = limbs.FR.pack_mont(values, device)
    return limbs.FR.unpack_mont(ntt_device(a, inverse))
