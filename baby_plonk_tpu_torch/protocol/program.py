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

from dataclasses import dataclass, field

from ..fields import fr
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
    #: engine name -> the 8 monomial polys [s1, s2, s3, ql, qr, qm, qo, qc]
    #: (prover round 3 and the verifier's preprocessing share them)
    coeff_cache: dict = field(default_factory=dict, repr=False, compare=False)
    #: (str(device), n) -> packed Lagrange sigma columns (TorchEngine round 2)
    sigma_lagrange: dict = field(default_factory=dict, repr=False, compare=False)
    #: ((4n, str(device)), rows): coset evaluations of the nine
    #: proof-independent rows (ops/prover_kernels.py round 3)
    coset_rows: tuple | None = field(default=None, repr=False, compare=False)


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

        return Program([eq_to_assembly(l) for l in lines], group_order)

    def common_preprocessed_input(self) -> CommonPreprocessedInput:
        """Cached on the program: the selector/σ polynomials are a pure
        function of the circuit, and sharing ONE CommonPreprocessedInput
        object between Prover and Verifier lets them share its derived
        caches too (the 8 iNTT'd coefficient polys, ``coeff_cache`` —
        a prove-then-verify service pays the selector iNTTs once)."""
        cpi = getattr(self, "_cpi_cache", None)
        if cpi is None:
            ql, qr, qm, qo, qc = self.make_gate_polynomials()
            s1, s2, s3 = self.make_s_polynomials()
            cpi = CommonPreprocessedInput(
                group_order=self.group_order,
                ql=ql, qr=qr, qm=qm, qo=qo, qc=qc, s1=s1, s2=s2, s3=s3,
            )
            self._cpi_cache = cpi
        return cpi

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
        rows (program.rs:172-194)."""
        out: list[str] = []
        no_more_allowed = False
        for coeff in self.coeffs():
            if PUBLIC in coeff:
                if no_more_allowed:
                    raise ValueError("Public var declarations must be at the top")
                names = [k for k in coeff if k is not None and not k.startswith("$")]
                out.append("".join(names))
            else:
                no_more_allowed = True
        return out
