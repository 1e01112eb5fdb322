"""The constraint DSL: one line -> wires (L, R, O) and the five selector
coefficients of its PLONK row.

Frozen copy of ``baby_plonk_tpu_torch/protocol/assembly.py`` at commit
7bdee1a (the parser and the coefficient extractors; semantics of
baby-plonk-rust src/assembly.rs), with the row returned as a tuple.
"""
from __future__ import annotations

from .fr import Q

OUTPUT_COEFF = "$output_coeff"
PUBLIC = "$public"


def is_valid_variable_name(name: str) -> bool:
    return bool(name) and name.isalnum() and not name[0].isdigit()


def get_product_key(key1, key2):
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


def evaluate(exprs: list[str], first_is_negative: bool = False) -> dict:
    """Split on the first '+', then '-', then '*'; leaves are integers or names."""
    if "+" in exprs:
        idx = exprs.index("+")
        return _merge_maps(evaluate(exprs[:idx], first_is_negative), evaluate(exprs[idx + 1 :], False))
    if "-" in exprs:
        idx = exprs.index("-")
        return _merge_maps(evaluate(exprs[:idx], first_is_negative), evaluate(exprs[idx + 1 :], True))
    if "*" in exprs:
        idx = exprs.index("*")
        return _multiply_maps(evaluate(exprs[:idx], first_is_negative), evaluate(exprs[idx + 1 :], first_is_negative))
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


def row(eq: str):
    """((L, R, O) variable names or None, (ql, qr, qm, qo, qc), the public
    variable's name or None) of one line."""
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
        variables: list[str] = []
        for t in tokens[2:]:
            var = t.lstrip("-")
            if is_valid_variable_name(var) and var not in variables:
                variables.append(var)
        allowed = set(variables) | {"", OUTPUT_COEFF}
        if len(variables) == 0:
            raise NotImplementedError("pure-constant constraints unsupported")
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
        wires = (variables[0], variables[1], out)
    elif op == "public":
        coeffs = {tokens[0]: Q - 1, OUTPUT_COEFF: 0, PUBLIC: 1}
        wires = (tokens[0], None, None)
    else:
        raise ValueError(f"Unsupported op: {op}")
    public = "".join(k for k in coeffs if k is not None and not k.startswith("$")) if PUBLIC in coeffs else None
    return wires, _gate(wires, coeffs), public


def _gate(wires, coeffs) -> tuple[int, int, int, int, int]:
    """(ql, qr, qm, qo, qc): every coefficient negated except the output's."""
    L, R, _ = wires
    ql = (-coeffs.get(L, 0)) % Q if L in coeffs else 0
    qr = (-coeffs[R]) % Q if R != L and R in coeffs else 0
    qm = 0
    if None not in wires:
        key = get_product_key(L, R)
        if key in coeffs:
            qm = (-coeffs[key]) % Q
    qo = coeffs.get(OUTPUT_COEFF, 1) % Q
    qc = (-coeffs.get(None, 0)) % Q
    return ql, qr, qm, qo, qc
