"""Circuit preprocessing: constraints -> selector + permutation polynomials.

Functional equivalent of src/program.rs. Produces the CommonPreprocessedInput:
Lagrange-basis selector polynomials ql, qr, qm, qo, qc (one row per
constraint, zero elsewhere; program.rs:51-75) and permutation polynomials
s1, s2, s3 built from the copy-constraint cycles (program.rs:76-147).

Permutation layout preserved exactly:
  * identity labels: column LEFT = w^i, RIGHT = 2*w^i, OUTPUT = 3*w^i
    (utils.rs:29-37) with cosets k1 = 2, k2 = 3;
  * s-column initial values: LEFT = w^i, RIGHT = 2w^i, OUTPUT = 0
    (program.rs:100-118) — OUTPUT zero-init is a reference quirk, every
    cell is subsequently overwritten by its cycle;
  * each variable's cell list is rotated by one: s[next_cell] =
    label(cell) (program.rs:122-133), with unused cells forming one big
    cycle under the None variable (program.rs:92-99).
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from itertools import chain, repeat
from typing import NamedTuple

import numpy as np

from .. import native
from ..fields import fr
from ..utils.metrics import get_metrics
from .assembly import PUBLIC, AssemblyEqn
from .poly import Basis, Poly

Q = fr.Q

# column tags (1-indexed to match utils.rs:6-21)
LEFT, RIGHT, OUTPUT = 1, 2, 3


def cell_label(group_order: int, column: int, row: int, _roots_cache={}) -> int:
    """Permutation identity label of a cell: w^row * column_coset (utils.rs:29-37)."""
    roots = _roots_cache.get(group_order)
    if roots is None:
        roots = fr.roots_of_unity(group_order)
        _roots_cache[group_order] = roots
    return roots[row] * column % Q


class PreprocessedCoeffs(NamedTuple):
    """The eight preprocessed polynomials in monomial form, on one engine."""

    ql: object
    qr: object
    qm: object
    qo: object
    qc: object
    s1: object
    s2: object
    s3: object


@dataclass
class CommonPreprocessedInput:
    group_order: int
    ql: Poly
    qr: Poly
    qm: Poly
    qo: Poly
    qc: Poly
    s1: Poly
    s2: Poly
    s3: Poly
    #: engine name -> ``PreprocessedCoeffs`` (``coeffs``)
    coeff_cache: dict = field(default_factory=dict, repr=False, compare=False)
    #: (str(device), n) -> packed Lagrange sigma columns (TorchEngine round 2)
    sigma_lagrange: dict = field(default_factory=dict, repr=False, compare=False)
    #: ((4n, str(device)), rows): coset evaluations of the nine
    #: proof-independent rows (ops/prover_kernels.py round 3)
    coset_rows: tuple | None = field(default=None, repr=False, compare=False)

    def coeffs(self, engine) -> PreprocessedCoeffs:
        """The eight polynomials in monomial form on ``engine``: one batched
        iNTT (the reference converts them one by one, prover.rs:374-397),
        kept per engine name, so that prover round 3 and the verifier's
        preprocessing share it."""
        got = self.coeff_cache.get(engine.name)
        if got is None:
            lagrange = [getattr(self, f) for f in PreprocessedCoeffs._fields]
            got = self.coeff_cache[engine.name] = PreprocessedCoeffs(*engine.intt_polys(lagrange))
        return got


@dataclass
class WireTable:
    """Where each wire of the circuit reads the witness: the program's
    variables in the order the column loop meets them (column L down every
    row, then R, then O), and ``index``, (3, n) int32: for each column and
    row the variable's position in ``names``, or ``len(names)`` (one zero
    slot) for a ``None`` wire and the padding rows. Built once per program
    (``Program.wire_table``).

    The table also keeps the key order of the last witness it learned
    (``learn``): every witness that one generator makes has the same keys in
    the same order, so ``packed`` reads such a witness by one native pass
    over the dict in its own order, checked key by key, instead of one
    lookup a name. The values are read anew on every call."""

    names: list[str]
    index: np.ndarray
    #: str(device) -> ``index`` on that device (the engine's gather)
    device_index: dict = field(default_factory=dict, repr=False, compare=False)
    #: (keys, slots): the learned witness key order, and for each key its
    #: position in ``names`` (int32, -1 where no wire reads it)
    order: tuple | None = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        self._get = operator.itemgetter(*self.names) if self.names else (lambda w: ())

    def values(self, witness: dict) -> list[int]:
        """The witness's values in ``names`` order, as given (unreduced).
        Raises ``KeyError`` naming the first missing variable and the row
        where the column loop first meets it."""
        try:
            got = self._get(witness)
        except KeyError:
            k, name = next((k, name) for k, name in enumerate(self.names) if name not in witness)
            row = int(np.flatnonzero(self.index.ravel() == k)[0]) % self.index.shape[1]
            raise KeyError(f"witness missing variable {name!r} (constraint row {row})") from None
        return [got] if len(self.names) == 1 else list(got)

    def learn(self, witness: dict) -> None:
        """Keep ``witness``'s key order for ``packed``: one dict lookup a
        key. Called after ``values`` found every name; a witness that is not
        a plain dict of ``str`` keys, or a process without the native
        reader, leaves the order as it was."""
        if type(witness) is not dict or native.witness_reader() is None:
            return
        keys = list(witness)
        if not all(type(k) is str for k in keys):
            return
        pos = {name: k for k, name in enumerate(self.names)}
        self.order = (keys, np.fromiter(map(pos.get, keys, repeat(-1)), np.int32, len(keys)))

    def packed(self, witness: dict) -> np.ndarray | None:
        """The witness's values in ``names`` order as (len(names), 32) uint8,
        each reduced below Q and little-endian (``FR.pack_mont``'s bytes),
        read by one native pass over the dict in its own order. None, with
        nothing usable read, where ``witness`` is not a plain dict with the
        learned keys in the learned order, or the native reader is missing. Values the pass leaves (negative, 2^256 or
        more, not an int) are reduced here, as ``pack_mont`` does."""
        order, read = self.order, native.witness_reader()
        if order is None or read is None:
            return None
        keys, slots = order
        n = len(self.names)
        out = np.empty((n, 32), dtype=np.uint8)
        flagged = np.empty(n, dtype=np.int32)
        k = read(witness, keys, slots.ctypes.data, _Q_WORDS.ctypes.data, out.ctypes.data, flagged.ctypes.data)
        if k < 0:
            return None
        for s in np.sort(flagged[:k]).tolist():
            out[s] = np.frombuffer(int.to_bytes(witness[self.names[s]] % Q, 32, "little"), np.uint8)
        return out


# the modulus as the native reader takes it; it subtracts Q at most twice
_Q_WORDS = np.frombuffer(Q.to_bytes(32, "little"), dtype="<u8").copy()
assert 3 * Q > 1 << 256


class Program:
    def __init__(self, constraints: list[AssemblyEqn], group_order: int):
        assert len(constraints) <= group_order, (
            f"{len(constraints)} constraints exceed group order {group_order}"
        )
        self.constraints = constraints
        self.group_order = group_order

    @staticmethod
    def from_strs(lines: list[str], group_order: int) -> "Program":
        from .assembly import eq_to_assembly

        with get_metrics().span("program.from_strs"):
            return Program([eq_to_assembly(l) for l in lines], group_order)

    def common_preprocessed_input(self) -> CommonPreprocessedInput:
        """Cached on the program: the selector/σ polynomials are a pure
        function of the circuit, and sharing ONE CommonPreprocessedInput
        object between Prover and Verifier lets them share its derived
        caches too (the 8 iNTT'd coefficient polys, ``coeffs`` — a
        prove-then-verify service pays the selector iNTTs once)."""
        cpi = getattr(self, "_cpi_cache", None)
        if cpi is None:
            with get_metrics().span("program.preprocess"):
                ql, qr, qm, qo, qc = self.make_gate_polynomials()
                s1, s2, s3 = self.make_s_polynomials()
            cpi = CommonPreprocessedInput(
                group_order=self.group_order,
                ql=ql, qr=qr, qm=qm, qo=qo, qc=qc, s1=s1, s2=s2, s3=s3,
            )
            self._cpi_cache = cpi
        return cpi

    def wire_table(self) -> WireTable:
        """The circuit's ``WireTable``, cached on the program like the
        preprocessed input: a function of the circuit alone."""
        table = getattr(self, "_wire_table", None)
        if table is None:
            cs = self.constraints
            cols = [[c.wires.L for c in cs], [c.wires.R for c in cs], [c.wires.O for c in cs]]
            slot = dict.fromkeys(chain(*cols))
            slot.pop(None, None)
            slot = {name: k for k, name in enumerate(slot)}
            index = np.full((3, self.group_order), len(slot), dtype=np.int32)
            for j, names in enumerate(cols):
                index[j, : len(cs)] = list(map(slot.get, names, repeat(len(slot))))
            table = self._wire_table = WireTable(list(slot), index)
        return table

    def make_gate_polynomials(self) -> tuple[Poly, Poly, Poly, Poly, Poly]:
        n = self.group_order
        L = [0] * n
        R = [0] * n
        M = [0] * n
        O = [0] * n
        C = [0] * n
        for i, constraint in enumerate(self.constraints):
            g = constraint.gate()
            L[i], R[i], M[i], O[i], C[i] = g.L, g.R, g.M, g.O, g.C
        return (
            Poly(L, Basis.LAGRANGE),
            Poly(R, Basis.LAGRANGE),
            Poly(M, Basis.LAGRANGE),
            Poly(O, Basis.LAGRANGE),
            Poly(C, Basis.LAGRANGE),
        )

    def make_s_polynomials(self) -> tuple[Poly, Poly, Poly]:
        n = self.group_order
        # variable -> ordered list of (column, row) cells, in the exact
        # append order of program.rs:79-99.
        variable_uses: dict[str | None, list[tuple[int, int]]] = {}
        for row, constraint in enumerate(self.constraints):
            for column, variable in enumerate(constraint.wires.to_list(), start=1):
                variable_uses.setdefault(variable, []).append((column, row))
        for row in range(len(self.constraints), n):
            for column in (LEFT, RIGHT, OUTPUT):
                variable_uses.setdefault(None, []).append((column, row))

        roots = fr.roots_of_unity(n)
        s = {
            LEFT: list(roots),
            RIGHT: [r * 2 % Q for r in roots],
            OUTPUT: [0] * n,  # reference quirk: zero-init (program.rs:115-118)
        }
        for uses in variable_uses.values():
            m = len(uses)
            for i, (column, row) in enumerate(uses):
                next_column, next_row = uses[(i + 1) % m]
                s[next_column][next_row] = cell_label(n, column, row)

        return (
            Poly(s[LEFT], Basis.LAGRANGE),
            Poly(s[RIGHT], Basis.LAGRANGE),
            Poly(s[OUTPUT], Basis.LAGRANGE),
        )

    def coeffs(self) -> list[dict[str | None, int]]:
        return [c.coeffs for c in self.constraints]

    def get_public_assignment(self) -> list[str]:
        """Names of the public-input variables, which must occupy the first
        rows (program.rs:172-194); found once a program, as the wire table."""
        out = getattr(self, "_public", None)
        if out is None:
            out = []
            no_more_allowed = False
            for coeff in self.coeffs():
                if PUBLIC in coeff:
                    if no_more_allowed:
                        raise ValueError("Public var declarations must be at the top")
                    names = [k for k in coeff if k is not None and not k.startswith("$")]
                    out.append("".join(names))
                else:
                    no_more_allowed = True
            self._public = out
        return list(out)
