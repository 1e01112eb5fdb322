"""The int8 inner product: sum a_i b_i over uint8 activations a_i in
[0, 256) and int8 weights b_i in [-128, 128), reduced into Fr, the sum
public, as a quantised layer's multiply-accumulate in verifiable inference
(ZEN, https://eprint.iacr.org/2021/087).

A frozen copy of ``baby_plonk_tpu_torch/circuits/library.py::
inner_product`` at commit 25e592c, so that a later change to the port's
circuits cannot move the yardstick, split in two: ``lines``, the constraint
lines, once; ``instance``, a witness for each input drawn from the seed,
without building the lines again. Rows: the public row, then a pair of rows
a term, ``p_i <== a_i * b_i`` and ``s_i <== s_{i-1} * 1 + p_i`` (``s0 <==
p0 * 1``), and the sum's row; 2 k + 2 rows over k terms, 4 k + 1 variables.
A CPU test holds the two against the port's ``inner_product``.
"""
from __future__ import annotations

Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def _terms(gates: int) -> int:
    if gates < 4 or gates % 2:
        raise ValueError(f"inner_product needs an even number of gates, at least 4, not {gates}")
    return (gates - 2) // 2


def lines(gates: int) -> list[str]:
    """The constraint lines of ``inner_product`` over (gates - 2) / 2 pairs."""
    k = _terms(gates)
    out = ["pub public", "p0 <== a0 * b0", "s0 <== p0 * 1"]
    for i in range(1, k):
        out += [f"p{i} <== a{i} * b{i}", f"s{i} <== s{i-1} * 1 + p{i}"]
    return out + [f"pub <== s{k-1} * 1"]


def instance(gates: int, rng) -> tuple[dict, list[int]]:
    """(witness, public values) of ``inner_product`` over (gates - 2) / 2
    pairs drawn from ``rng`` (a ``random.Random``): for each pair a_i =
    ``randrange(256)``, then b_i = ``randrange(-128, 128)`` reduced (a
    negative weight is Q - |b_i|). The witness's keys in the port's order
    (a_i, b_i, p_i, s_i, ..., pub); the public values [s_last]."""
    witness, s = {}, 0
    for i in range(_terms(gates)):
        a, b = rng.randrange(256), rng.randrange(-128, 128) % Q
        p = a * b % Q
        s = (s + p) % Q
        witness[f"a{i}"], witness[f"b{i}"], witness[f"p{i}"], witness[f"s{i}"] = a, b, p, s
    witness["pub"] = s
    return witness, [s]
