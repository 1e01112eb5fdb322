"""Reusable circuit families for tests and benchmarks.

The reference ships a single hard-coded 3-constraint example
(tests/verify_proof_test.rs:16-44); these functions generate arbitrary-size
instances of common constraint shapes within the DSL's limits (<= 2
distinct variables per constraint, ops +,-,*; public rows first).

Each function returns ``(constraints, witness, public_values)`` ready for
``Program.from_strs(constraints, group_order)`` / ``prover.prove(witness)``
/ ``verifier.verify(public_values)``.
"""
from __future__ import annotations

from ..fields import fr

Q = fr.Q


def mul_chain(gates: int, x0: int = 3):
    """x_{i+1} <== x_i * x_i + x_i — a sequential squaring chain whose
    final value is public. Uses gates rows (including the public row)."""
    assert gates >= 3
    constraints = ["pub public"]
    witness = {"x0": x0 % Q}
    x = x0 % Q
    for i in range(gates - 2):
        nxt = (x * x + x) % Q
        constraints.append(f"x{i+1} <== x{i} * x{i} + x{i}")
        witness[f"x{i+1}"] = nxt
        x = nxt
    constraints.append(f"pub <== x{gates-2} * 1")
    witness["pub"] = x
    return constraints, witness, [x]


def fib_chain(gates: int, a: int = 1, b: int = 1):
    """f_{i+2} <== f_{i+1} + f_i (Fibonacci recurrence), final value public."""
    assert gates >= 3
    constraints = ["pub public"]
    witness = {"f0": a % Q, "f1": b % Q}
    vals = [a % Q, b % Q]
    for i in range(gates - 2):
        nxt = (vals[-1] + vals[-2]) % Q
        constraints.append(f"f{i+2} <== f{i+1} * 1 + f{i}")
        witness[f"f{i+2}"] = nxt
        vals.append(nxt)
    constraints.append(f"pub <== f{len(vals)-1} * 1")
    witness["pub"] = vals[-1]
    return constraints, witness, [vals[-1]]


def inner_product(pairs: list[tuple[int, int]]):
    """acc = sum a_i * b_i, accumulated pairwise; result public.

    Note: each product row uses two fresh variables, each accumulate row
    two more — 2*len(pairs) + 2 rows total."""
    constraints = ["pub public"]
    witness = {}
    acc = 0
    for i, (a, b) in enumerate(pairs):
        a, b = a % Q, b % Q
        witness[f"a{i}"] = a
        witness[f"b{i}"] = b
        p = a * b % Q
        constraints.append(f"p{i} <== a{i} * b{i}")
        witness[f"p{i}"] = p
        nxt = (acc + p) % Q
        if i == 0:
            constraints.append(f"s0 <== p0 * 1")
        else:
            constraints.append(f"s{i} <== s{i-1} * 1 + p{i}")
        witness[f"s{i}"] = nxt
        acc = nxt
    constraints.append(f"pub <== s{len(pairs)-1} * 1")
    witness["pub"] = acc
    return constraints, witness, [acc]


def poly_eval(coeffs: list[int], x: int):
    """Horner evaluation of sum c_i x^i at a witness point; result public.

    The evaluation point is a witness variable reused across rows; each
    Horner step h_{k} <== h_{k+1} * x + c_k is one gate (constant c_k
    folded into the gate's constant term)."""
    assert len(coeffs) >= 2
    x = x % Q
    n = len(coeffs)
    constraints = ["pub public"]
    witness = {"x": x}
    acc = coeffs[-1] % Q
    witness["h0"] = acc
    constraints.append(f"h0 <== x * 0 + {coeffs[-1] % Q}")
    for k in range(1, n):
        c = coeffs[n - 1 - k] % Q
        nxt = (acc * x + c) % Q
        constraints.append(f"h{k} <== h{k-1} * x + {c}")
        witness[f"h{k}"] = nxt
        acc = nxt
    constraints.append(f"pub <== h{n-1} * 1")
    witness["pub"] = acc
    return constraints, witness, [acc]
