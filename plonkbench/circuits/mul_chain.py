"""The multiply chain x_{i+1} = x_i^2 + x_i, its last value public.

A frozen copy of ``baby_plonk_tpu_torch/circuits/library.py::mul_chain``
at commit 7bdee1a, so that a later change to the port's circuits cannot
move the yardstick, split in two: ``lines``, the constraint lines, once;
``instance``, a witness for each input drawn from the seed, without
building the lines again. A CPU test holds the two against the port's
``mul_chain``.
"""
from __future__ import annotations

Q = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


def lines(gates: int) -> list[str]:
    """The constraint lines of ``mul_chain(gates)``."""
    if gates < 3:
        raise ValueError(f"mul_chain needs at least 3 gates, not {gates}")
    return ["pub public"] + [f"x{i+1} <== x{i} * x{i} + x{i}" for i in range(gates - 2)] + [f"pub <== x{gates-2} * 1"]


def instance(gates: int, rng) -> tuple[dict, list[int]]:
    """(witness, public values) of ``mul_chain(gates, x0)`` for an x0 drawn
    from ``rng`` (a ``random.Random``)."""
    x = rng.randrange(Q)
    witness = {"x0": x}
    for i in range(1, gates - 1):
        x = (x * x + x) % Q
        witness[f"x{i}"] = x
    witness["pub"] = x
    return witness, [x]
