"""Inline-PTX carry chains for the Fr / Fq arithmetic of ``csrc/field.cuh``.

``header()`` returns the text of ``field_asm.cuh``, which the build writes
beside the objects and ``field.cuh`` includes: for each field the Montgomery
product, the Montgomery square, modular add and sub, and (Fq only) an
unreduced add. Every function is ONE ``asm`` statement: the carry flag is
no operand of an ``asm``, so a chain split over statements could have
another flag-writing instruction scheduled into it. Temporaries are PTX
registers declared inside the statement's own scope.

Design of the product (32-bit words, N = 8 for Fr, 12 for Fq, R = 2^(32 N)).
The running sum t of the word-serial Montgomery product (t += a b_i;
t += m p with m = t_0 (-p^-1); t >>= 32) is kept as two accumulators whose
sum it is, X on word weights 0..N and Y on weights 1..N. The products of
the even words of a (or p) by one word put their low halves on even weights
and their high halves on the odd weight above: one carry chain
``mad.lo.cc, madc.hi.cc, madc.lo.cc, ...`` over consecutive words of X with
no carry word between the products; the odd words' products do the same on
Y, one weight up. The two chains of a row are independent, and each
``lo/hi`` pair is one wide multiply-add of the integer pipe. Shifting t down
a word swaps the roles: Y becomes the new X, X's words 2..N the new Y, and
X's word 1 (weight 0 after the shift) is added into the new X's word 0, its
carry running on into the odd chain that follows in the same statement.

Bounds. With a < 4p and any N-word b, t < a + p after each row and
t < (a + p)(2^32 + 1) < 2^(32 (N + 1)) inside one: X needs N + 1 words, Y
needs N, and no carry leaves either. The result (a b + m p) / R is below
a b / R + p, so it is below 2p and one conditional subtraction makes it
canonical whenever a b < R p: always for canonical operands, and for Fq
(R > 9.8 p) also for a, b < 2p or a < p, b < 8p. The square builds the
2N-word a^2 (cross products once, doubled, then the diagonal), and reduces
it with the same rows without their a b_i half.

``simulate`` interprets the emitted PTX text on Python ints, so the CPU
tests hold every function against exact integer arithmetic
(tests/test_torch_field_asm.py); the card holds them against the plain
PyTorch product (chip_smoke.py, phase 3).
"""
from __future__ import annotations

import functools

from ..fields import fq, fr

MASK32 = 0xFFFFFFFF

#: name -> (modulus, 32-bit words)
FIELDS = {"fr": (fr.Q, 8), "fq": (fq.P, 12)}


def words(value: int, n: int) -> list[int]:
    return [(value >> (32 * i)) & MASK32 for i in range(n)]


def from_words(ws) -> int:
    return sum(int(w) << (32 * i) for i, w in enumerate(ws))


class Asm:
    """One ``asm`` statement under construction: ``outs`` and ``ins`` are the
    C operands (names like ``r0``), every other name is a PTX temporary."""

    def __init__(self, outs, ins):
        self.outs, self.ins = list(outs), list(ins)
        self.lines: list[tuple] = []
        self.temps: list[str] = []

    def op(self, name, dst, *srcs):
        for r in (dst, *srcs):
            if isinstance(r, str) and r not in self.outs and r not in self.ins and r not in self.temps:
                self.temps.append(r)
        self.lines.append((name, dst, srcs))

    def _tok(self, r) -> str:
        if isinstance(r, int):
            return f"0x{r:08x}"
        if r in self.outs:
            return f"%{self.outs.index(r)}"
        if r in self.ins:
            return f"%{len(self.outs) + self.ins.index(r)}"
        return r

    def text(self) -> list[str]:
        """The PTX lines of the statement, braces and declarations included."""
        out = ["{"]
        temps = sorted(t for t in self.temps if t != "pr")
        for i in range(0, len(temps), 12):
            out.append(".reg .u32 " + ", ".join(temps[i : i + 12]) + ";")
        if "pr" in self.temps:
            out.append(".reg .pred pr;")
        for name, dst, srcs in self.lines:
            out.append(f"{name} " + ", ".join(self._tok(r) for r in (dst, *srcs)) + ";")
        out.append("}")
        return out


# -- chains ---------------------------------------------------------------------


def _mad_chain(s: Asm, acc, mults, scalar, carry_in=False, carry_word=None):
    """acc[2k], acc[2k+1] += lo, hi of mults[k] * scalar as one carry chain
    over consecutive words; ``carry_in`` continues a chain already open;
    the carry out goes into ``carry_word`` (dropped where it is provably 0)."""
    n = len(mults)
    for k, m in enumerate(mults):
        first = k == 0 and not carry_in
        s.op("mad.lo.cc.u32" if first else "madc.lo.cc.u32", acc[2 * k], m, scalar, acc[2 * k])
        last = k == n - 1 and carry_word is None
        s.op("madc.hi.u32" if last else "madc.hi.cc.u32", acc[2 * k + 1], m, scalar, acc[2 * k + 1])
    if carry_word is not None:
        s.op("addc.u32", carry_word, carry_word, 0)


def _add_chain(s: Asm, dst, a, b):
    """dst = a + b over len(dst) words as one carry chain; the carry out of
    the top word is dropped (the callers' bounds make it 0)."""
    n = len(dst)
    for k in range(n):
        s.op("add.cc.u32" if k == 0 else ("addc.cc.u32" if k < n - 1 else "addc.u32"), dst[k], a[k], b[k])


def _reduce_row(s: Asm, X, Y, p, pinv, tag, carry_in=False):
    """t += m p with m = X[0] (-p^-1): X[0] becomes 0. ``carry_in``: the
    carry of the ``add.cc`` that closed ``_shift`` is still open (``mul.lo``
    leaves the flag alone) and runs into the chain over Y."""
    n = len(p)
    m = f"m{tag}"
    s.op("mul.lo.u32", m, X[0], pinv)
    _mad_chain(s, Y, p[1::2], m, carry_in=carry_in)
    _mad_chain(s, X, p[0::2], m, carry_word=X[n])


def _shift(s: Asm, X, Y, tag, a=None, scalar=None):
    """t >>= 32 (X[0] is 0), then t += a * scalar when ``a`` is given; without
    ``a`` the carry of the last ``add.cc`` is left open for the ``_reduce_row``
    that follows. Returns the new (X, Y)."""
    n = len(Y)
    nX = list(Y) + [f"xs{tag}"]          # Y: weights 1..N -> 0..N-1, plus a fresh top word
    nY = list(X[2:]) + [f"ys{tag}"]      # X: weights 2..N -> 1..N-1, plus a fresh top word
    s.op("mov.u32", nX[n], 0)
    s.op("mov.u32", nY[n - 1], 0)
    s.op("add.cc.u32", nX[0], nX[0], X[1])  # X[1] lands on weight 0
    if a is not None:
        _mad_chain(s, nY, a[1::2], scalar, carry_in=True)
        _mad_chain(s, nX, a[0::2], scalar, carry_word=nX[n])
    return nX, nY


def _finish(s: Asm, X, Y, p, r, extra=None):
    """r = (X + 2^32 Y) / 2^32 (+ extra), minus p when that is not negative."""
    n = len(p)
    t = _names("t", n)
    _add_chain(s, t, X[1:], Y)
    if extra is not None:
        _add_chain(s, t, t, extra)
    _cond_sub(s, t, p, r)


def _cond_sub(s: Asm, t, p, r):
    """r = t - p if t >= p else t (t < 2p in N words)."""
    n = len(p)
    d = _names("d", n)
    for k in range(n):
        s.op("sub.cc.u32" if k == 0 else "subc.cc.u32", d[k], t[k], p[k])
    s.op("subc.u32", "bw", 0, 0)  # 0 or 0xffffffff: the borrow
    s.op("setp.ne.u32", "pr", "bw", 0)
    for k in range(n):
        s.op("selp.u32", r[k], t[k], d[k], "pr")


def _names(prefix, n):
    return [f"{prefix}{k}" for k in range(n)]


def _pinv(p: int) -> int:
    return (-pow(p, -1, 1 << 32)) & MASK32


# -- the functions ----------------------------------------------------------------


def gen_mul(field: str) -> Asm:
    p_int, n = FIELDS[field]
    p, pinv = words(p_int, n), _pinv(p_int)
    r, a, b = _names("r", n), _names("a", n), _names("b", n)
    s = Asm(r, a + b)
    X, Y = _names("x", n + 1), _names("y", n)
    # row 0: t = a b_0
    for k in range(n // 2):
        s.op("mul.lo.u32", X[2 * k], a[2 * k], b[0])
        s.op("mul.hi.u32", X[2 * k + 1], a[2 * k], b[0])
        s.op("mul.lo.u32", Y[2 * k], a[2 * k + 1], b[0])
        s.op("mul.hi.u32", Y[2 * k + 1], a[2 * k + 1], b[0])
    s.op("mov.u32", X[n], 0)
    for i in range(1, n + 1):
        _reduce_row(s, X, Y, p, pinv, i)
        if i < n:
            X, Y = _shift(s, X, Y, i, a, b[i])
    _finish(s, X, Y, p, r)
    return s


def gen_sqr(field: str) -> Asm:
    p_int, n = FIELDS[field]
    p, pinv = words(p_int, n), _pinv(p_int)
    r, a = _names("r", n), _names("a", n)
    s = Asm(r, a)
    # cross products a_i a_j, i < j, at weight i + j: the products that start
    # on an odd weight go to O, those on an even weight to E. A chain's carry
    # lands on the word above it, which until then holds only earlier carries
    # (the chains' tops never fall from row to row), so it cannot ripple.
    E, O = _names("e", 2 * n), _names("o", 2 * n)
    for w in range(2 * n):
        s.op("mov.u32", E[w], 0)
        s.op("mov.u32", O[w], 0)
    for i in range(n - 1):
        odd, even = a[i + 1 :: 2], a[i + 2 :: 2]
        lo = 2 * i + 1
        _mad_chain(s, O[lo:], odd, a[i], carry_word=O[lo + 2 * len(odd)])
        if even:
            lo = 2 * i + 2
            _mad_chain(s, E[lo:], even, a[i], carry_word=E[lo + 2 * len(even)])
    T = _names("q", 2 * n)
    _add_chain(s, T, E, O)  # the cross products ...
    _add_chain(s, T, T, T)  # ... doubled
    for k in range(n):      # T += a_k^2 at weight 2k: one chain over all 2N words
        s.op("mad.lo.cc.u32" if k == 0 else "madc.lo.cc.u32", T[2 * k], a[k], a[k], T[2 * k])
        s.op("madc.hi.cc.u32" if k < n - 1 else "madc.hi.u32", T[2 * k + 1], a[k], a[k], T[2 * k + 1])
    # Montgomery reduction of the low half; the high half joins at the end
    X, Y = T[:n] + ["xtop"], _names("y", n)
    s.op("mov.u32", X[n], 0)
    for k in range(n):
        s.op("mov.u32", Y[k], 0)
    for i in range(1, n + 1):
        _reduce_row(s, X, Y, p, pinv, i, carry_in=i > 1)
        if i < n:
            X, Y = _shift(s, X, Y, i)
    _finish(s, X, Y, p, r, extra=T[n:])
    return s


def gen_add(field: str, reduce: bool = True) -> Asm:
    p_int, n = FIELDS[field]
    p = words(p_int, n)
    r, a, b = _names("r", n), _names("a", n), _names("b", n)
    s = Asm(r, a + b)
    t = _names("t", n) if reduce else r
    _add_chain(s, t, a, b)
    if reduce:
        _cond_sub(s, t, p, r)
    return s


def gen_sub(field: str) -> Asm:
    """r = a - b, plus p where that is negative (a, b canonical)."""
    p_int, n = FIELDS[field]
    p = words(p_int, n)
    r, a, b = _names("r", n), _names("a", n), _names("b", n)
    s = Asm(r, a + b)
    d, q = _names("d", n), _names("q", n)
    for k in range(n):
        s.op("sub.cc.u32" if k == 0 else "subc.cc.u32", d[k], a[k], b[k])
    s.op("subc.u32", "bw", 0, 0)
    for k in range(n):
        s.op("and.b32", q[k], "bw", p[k])
    _add_chain(s, r, d, q)
    return s


@functools.lru_cache(maxsize=None)
def functions() -> dict:
    """C function name -> (its statement, the operand arrays besides r)."""
    out = {}
    for f in FIELDS:
        out[f"{f}_mul"] = (gen_mul(f), ("a", "b"))
        out[f"{f}_sqr"] = (gen_sqr(f), ("a",))
        out[f"{f}_add"] = (gen_add(f), ("a", "b"))
        out[f"{f}_sub"] = (gen_sub(f), ("a", "b"))
    out["fq_add_lazy"] = (gen_add("fq", reduce=False), ("a", "b"))
    return out


def header() -> str:
    """The text of ``field_asm.cuh``."""
    parts = [
        "// Written by baby_plonk_tpu_torch/ops/field_asm.py at build time: the design,\n"
        "// the bounds and the CPU check of these carry chains are described there.\n"
        "#pragma once\n#include <cstdint>\n\nnamespace bpt {\nnamespace ptx {\n"
    ]
    for name, (s, arrays) in functions().items():
        n = len(s.outs)
        args = ", ".join([f"uint32_t r[{n}]"] + [f"const uint32_t {x}[{n}]" for x in arrays])
        body = "\n".join(f'      "{line}\\n\\t"' for line in s.text())
        outs = ", ".join(f'"=r"(r[{k}])' for k in range(n))
        ins = ", ".join(f'"r"({x}[{k}])' for x in arrays for k in range(n))
        parts.append(
            f"__device__ __forceinline__ void {name}({args}) {{\n  asm(\n{body}\n      : {outs}\n      : {ins});\n}}\n"
        )
    parts.append("}  // namespace ptx\n}  // namespace bpt\n")
    return "\n".join(parts)


# -- interpreter -------------------------------------------------------------------


def simulate(lines: list[str], n_out: int, inputs: list[int]) -> list[int]:
    """Run the PTX text of one statement (``Asm.text()``) on 32-bit words:
    operands %0..%(n_out-1) are the outputs, the following ones ``inputs``."""
    regs: dict[str, int] = {f"%{n_out + i}": int(v) & MASK32 for i, v in enumerate(inputs)}
    cf = 0

    def val(tok: str) -> int:
        return int(tok, 16) if tok.startswith("0x") else regs[tok]

    for line in lines:
        line = line.strip().rstrip(";")
        if line in ("{", "}") or line.startswith(".reg"):
            continue
        name, rest = line.split(" ", 1)
        ops = [t.strip() for t in rest.split(",")]
        dst, src = ops[0], [val(t) for t in ops[1:-1]] + [ops[-1]]
        parts = name.split(".")
        base, cc = parts[0], "cc" in parts
        if base == "selp":
            regs[dst] = src[0] if regs[src[2]] else src[1]
            continue
        src[-1] = val(src[-1])
        if base == "setp":
            regs[dst] = int(src[0] != src[1])
            continue
        if base == "mov":
            full = src[0]
        elif base == "and":
            full = src[0] & src[1]
        elif base == "mul":
            prod = src[0] * src[1]
            full = prod >> 32 if "hi" in parts else prod & MASK32
        elif base in ("mad", "madc"):
            prod = src[0] * src[1]
            full = (prod >> 32 if "hi" in parts else prod & MASK32) + src[2] + (cf if base == "madc" else 0)
        elif base in ("add", "addc"):
            full = src[0] + src[1] + (cf if base == "addc" else 0)
        elif base in ("sub", "subc"):
            full = src[0] - src[1] - (cf if base == "subc" else 0)
        else:
            raise ValueError(f"unknown instruction {name}")
        if cc:
            cf = int(full < 0 or full > MASK32)
        regs[dst] = full & MASK32
    return [regs[f"%{i}"] for i in range(n_out)]


def run(name: str, *operands: int) -> int:
    """Function ``name`` of the header on integer operands, through the
    interpreter: the integer its output words hold."""
    s, arrays = functions()[name]
    n = len(s.outs)
    assert len(operands) == len(arrays)
    ins = [w for v in operands for w in words(v, n)]
    return from_words(simulate(s.text(), n, ins))
