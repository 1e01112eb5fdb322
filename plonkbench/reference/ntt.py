"""Number-theoretic transforms over Fr on numpy arrays of Python integers.

Plain radix-2 transforms, one stage at a time over the whole array (numpy
applies Python's integer arithmetic element by element), so that the
reference can work out a polynomial's values on a coset of 4n points at
n = 2^16 in about a second a transform. Nothing here comes from the
program.
"""
from __future__ import annotations

from itertools import accumulate

import numpy as np

from . import fr

Q = fr.Q


def powers(x: int, count: int, start: int = 1) -> list[int]:
    """[start, start x, start x^2, ...], ``count`` of them."""
    return list(accumulate([x] * (count - 1), lambda p, _: p * x % Q, initial=start % Q))


def ints(values) -> np.ndarray:
    """An array of Python integers (never a fixed-width dtype)."""
    values = list(values)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def ntt(values, root: int) -> np.ndarray:
    """The values sum_i v_i root^(i j) for j < N, in natural order, where N =
    len(values) is a power of two and root a primitive N-th root of unity."""
    x = ints(values)
    size = len(x)
    if size & (size - 1):
        raise ValueError(f"length {size}: expected a power of two")
    out = x.reshape(1, size)
    while out.shape[0] < size:
        m, half = out.shape[0], out.shape[1] // 2
        twiddle = ints(powers(pow(root, size // (2 * m), Q), m)).reshape(m, 1)
        even, odd = out[:, :half], out[:, half:] * twiddle % Q
        out = np.vstack([even + odd, even - odd])
    return out.ravel() % Q


def intt(values, root: int) -> np.ndarray:
    """The inverse of ``ntt`` with the same root."""
    return ntt(values, fr.inv(root)) * fr.inv(len(values)) % Q


def coset_values(lagrange, factor: int, coset: int) -> np.ndarray:
    """A polynomial given by its values at the n-th roots of unity, at the
    ``factor`` n points coset * w^j of the (factor n)-th roots w."""
    n = len(lagrange)
    coeffs = intt(lagrange, fr.root_of_unity(n)) * ints(powers(coset, n)) % Q
    return ntt(np.concatenate([coeffs, ints([0] * ((factor - 1) * n))]), fr.root_of_unity(factor * n))


def batch_inv(values: np.ndarray) -> np.ndarray:
    """1 / v for each v (none may be 0), with one inversion."""
    prefix = list(accumulate(values, lambda p, v: p * v % Q, initial=1))
    if prefix[-1] == 0:
        raise ZeroDivisionError("batch inversion of zero")
    out = np.empty(len(values), dtype=object)
    acc = fr.inv(prefix[-1])
    for i in range(len(values) - 1, -1, -1):
        out[i] = acc * prefix[i] % Q
        acc = acc * values[i] % Q
    return out
