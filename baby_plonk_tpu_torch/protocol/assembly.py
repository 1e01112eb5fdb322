"""Arithmetic-equation DSL -> PLONK gate frontend.

Functional equivalent of src/assembly.rs: parses constraint strings like
``"c <== a * b + b"`` or ``"e public"`` into wire assignments {L, R, O}
and a coefficient map, from which the 5 PLONK selector coefficients
(ql, qr, qm, qo, qc) are derived.

Semantics preserved exactly (assembly.rs:159-250):
  * ops ``<==`` / ``===`` and ``public``;
  * expression evaluation splits on the first ``+``, then ``-``, then
    ``*`` (assembly.rs:318-378), constants may be negative;
  * at most 2 distinct variables per constraint (assembly.rs:202);
  * 1-variable equations duplicate the variable into the R wire
    (assembly.rs:190-195);
  * ``-out <== ...`` flips the output coefficient (assembly.rs:167-170);
  * coefficient extractors negate everything except the output coeff
    (assembly.rs:30-72);
  * product keys are '*'-joined sorted variable names (assembly.rs:405-427).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..fields import fr

Q = fr.Q

OUTPUT_COEFF = "$output_coeff"
PUBLIC = "$public"


@dataclass
class GateWire:
    """Wire variable names for a gate row; None = unused cell (assembly.rs:4-8)."""

    L: str | None
    R: str | None
    O: str | None

    def to_list(self) -> list[str | None]:
        return [self.L, self.R, self.O]


@dataclass
class Gate:
    """Selector coefficients of one PLONK row (assembly.rs:15-21)."""

    L: int
    R: int
    M: int
    O: int
    C: int


@dataclass
class AssemblyEqn:
    wires: GateWire
    coeffs: dict[str | None, int] = field(default_factory=dict)

    # coefficient extractors (assembly.rs:30-72): everything negated
    # except the output coefficient.
    def l(self) -> int:
        return (-self.coeffs.get(self.wires.L, 0)) % Q if self.wires.L in self.coeffs else 0

    def r(self) -> int:
        if self.wires.R != self.wires.L and self.wires.R in self.coeffs:
            return (-self.coeffs[self.wires.R]) % Q
        return 0

    def m(self) -> int:
        if None not in self.wires.to_list():
            key = get_product_key(self.wires.L, self.wires.R)
            if key in self.coeffs:
                return (-self.coeffs[key]) % Q
        return 0

    def o(self) -> int:
        return self.coeffs.get(OUTPUT_COEFF, 1) % Q

    def c(self) -> int:
        return (-self.coeffs.get(None, 0)) % Q

    def gate(self) -> Gate:
        return Gate(self.l(), self.r(), self.m(), self.o(), self.c())

    @staticmethod
    def from_str(eq: str) -> "AssemblyEqn":
        return eq_to_assembly(eq)


def is_valid_variable_name(name: str) -> bool:
    return bool(name) and name.isalnum() and not name[0].isdigit()


def get_product_key(key1: str | None, key2: str | None) -> str | None:
    """Sorted '*'-joined product key (assembly.rs:405-427)."""
    if key1 is not None and key2 is not None:
        members = sorted(key1.split("*") + key2.split("*"))
        return "*".join(m for m in members if m)
    return key1 if key1 is not None else key2


def _merge_maps(m1: dict, m2: dict) -> dict:
    out: dict = {}
    for k, v in list(m1.items()) + list(m2.items()):
        out[k] = (out.get(k, 0) + v) % Q
    return out


def _multiply_maps(m1: dict, m2: dict) -> dict:
    out: dict = {}
    for k1, v1 in m1.items():
        for k2, v2 in m2.items():
            key = get_product_key(k1, k2)
            out[key] = (out.get(key, 0) + v1 * v2) % Q
    return out


def evaluate(exprs: list[str], first_is_negative: bool = False) -> dict[str | None, int]:
    """Recursive-descent expression evaluation (assembly.rs:318-378).

    Splits on the first '+', then the first '-', then the first '*';
    leaves are integer literals or variable names.
    """
    if "+" in exprs:
        idx = exprs.index("+")
        return _merge_maps(
            evaluate(exprs[:idx], first_is_negative), evaluate(exprs[idx + 1 :], False)
        )
    if "-" in exprs:
        idx = exprs.index("-")
        return _merge_maps(
            evaluate(exprs[:idx], first_is_negative), evaluate(exprs[idx + 1 :], True)
        )
    if "*" in exprs:
        idx = exprs.index("*")
        return _multiply_maps(
            evaluate(exprs[:idx], first_is_negative),
            evaluate(exprs[idx + 1 :], first_is_negative),
        )
    if len(exprs) > 1:
        raise ValueError(f"No ops, expected sub-expr to be a unit: {exprs[1]}")
    tok = exprs[0]
    if tok.startswith("-"):
        return evaluate([tok[1:]], not first_is_negative)
    try:
        value = int(tok)
    except ValueError:
        value = None
    if value is not None:
        v = abs(value) % Q
        return {None: (-v) % Q if first_is_negative else v}
    if is_valid_variable_name(tok):
        return {tok: (Q - 1) if first_is_negative else 1}
    raise ValueError(f"unparseable token: {tok!r}")


def eq_to_assembly(eq: str) -> AssemblyEqn:
    """Parse one constraint line (assembly.rs:159-250)."""
    tokens = eq.strip().split(" ")
    if len(tokens) < 2:
        raise ValueError(f"malformed constraint: {eq!r}")
    op = tokens[1]
    if op in ("<==", "==="):
        out = tokens[0]
        coeffs = evaluate(tokens[2:])
        if out.startswith("-"):
            out = out[1:]
            coeffs[OUTPUT_COEFF] = Q - 1
        if not is_valid_variable_name(out):
            raise ValueError(f"Invalid out variable name: {out}")
        # variables in order of first appearance (deduped)
        variables: list[str] = []
        for t in tokens[2:]:
            var = t.lstrip("-")
            if is_valid_variable_name(var) and var not in variables:
                variables.append(var)
        allowed = set(variables) | {"", OUTPUT_COEFF}
        if len(variables) == 0:
            raise NotImplementedError("pure-constant constraints unsupported (as in reference)")
        elif len(variables) == 1:
            variables.append(variables[0])
            allowed.add(get_product_key(variables[0], variables[1]))
        elif len(variables) == 2:
            allowed.add(get_product_key(variables[0], variables[1]))
        else:
            raise ValueError(f"Max 2 variables, found {len(variables)}")
        for key in coeffs:
            if key is not None and key not in allowed:
                raise ValueError("Disallowed multiplication")
        wires = GateWire(L=variables[0], R=variables[1], O=out)
        return AssemblyEqn(wires=wires, coeffs=coeffs)
    elif op == "public":
        coeffs = {tokens[0]: Q - 1, OUTPUT_COEFF: 0, PUBLIC: 1}
        return AssemblyEqn(wires=GateWire(L=tokens[0], R=None, O=None), coeffs=coeffs)
    else:
        raise ValueError(f"Unsupported op: {op}")
