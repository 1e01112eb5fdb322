"""Round 1's columns (``Program.wire_table``, each engine's
``wire_columns``) and the polynomials made from a few scalars
(``DPoly.sparse``, ``engine.sparse_poly``), held on the CPU against plain
loops over the constraints.

Proofs of ``TorchEngine("cpu")`` are compared byte for byte with
``HostEngine``'s under the same blinding. Both commit through the host MSM
(``Setup.commit``): the plain device MSM takes seconds a commit here, and a
commitment is a function of the polynomial's coefficients alone, which is
what this compares.
"""
import pytest

from baby_plonk_tpu_torch.circuits.library import fib_chain, inner_product, mul_chain, poly_eval
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops.dpoly import DPoly
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup
from baby_plonk_tpu_torch.protocol.poly import Basis, Poly
from baby_plonk_tpu_torch.utils.metrics import get_metrics

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

Q = fr.Q
BLINDING = [Q - 1, 2, 3 * Q + 5, 4, 5, 6, 7, 8, 9, 10, 11]


class HostCommits(TorchEngine):
    """TorchEngine("cpu") with every commitment made by the host MSM."""

    def commit_many(self, setup, polys):
        return [setup.commit(Poly(p.values, p.basis)) for p in polys]


def _circuit(case):
    """(constraint lines, witness, group order) of each case."""
    if case == "public row, None wires, padding":
        lines, w, _ = mul_chain(5, 11)
        return lines, w, 8
    if case == "one variable in all three columns":
        return ["a public", "x <== x * x", "b <== x * a"], {"a": 7, "x": 1, "b": 7}, 8
    if case == "several public inputs":
        lines = ["a public", "b public", "c public", "d <== a * b", "e <== d * c"]
        return lines, {"a": 3, "b": 5, "c": 7, "d": 15, "e": 105}, 8
    if case == "long padding":
        lines, w, _ = fib_chain(10, 2, 3)
        return lines, w, 64
    if case == "two fresh variables a row":
        lines, w, _ = inner_product([(2, 3), (4, 5), (6, 7)])
        return lines, w, 16
    if case == "one variable in many rows":
        lines, w, _ = poly_eval([3, 1, 4, 1, 5, 9], 2)
        return lines, w, 32
    raise KeyError(case)


CASES = ["public row, None wires, padding", "one variable in all three columns", "several public inputs",
         "long padding", "two fresh variables a row", "one variable in many rows"]
_setups = {}


def _setup(n):
    if n not in _setups:
        _setups[n] = Setup.generate_srs(n + 6, 0xDEADBEEF, cache=False)
    return _setups[n]


def _proofs(program, witness):
    """(host proof bytes, device proof bytes, device_columns counted by each)."""
    out = []
    for engine in (HostEngine(), HostCommits("cpu")):
        m = get_metrics()
        m.reset()
        proof = Prover(_setup(program.group_order), program, engine).prove(witness, blinding=BLINDING)
        out.append((proof.to_bytes(), m.counters.get("device_columns", 0)))
        m.reset()
    (host, host_cols), (dev, dev_cols) = out
    return host, dev, host_cols, dev_cols


def _host_columns(program, witness):
    """Round 1's three columns by a loop over the constraints' wires."""
    n = program.group_order
    cols = [[0] * n for _ in range(3)]
    for i, c in enumerate(program.constraints):
        for j, name in enumerate(c.wires.to_list()):
            if name is not None:
                cols[j][i] = witness[name] % Q
    return cols


@pytest.mark.parametrize("case", CASES)
def test_device_columns_prove_the_host_engines_bytes(case):
    lines, witness, n = _circuit(case)
    host, dev, host_cols, dev_cols = _proofs(Program.from_strs(lines, n), witness)
    assert dev == host
    assert (host_cols, dev_cols) == (0, 3)


def test_witness_values_above_q_and_negative_are_reduced_as_before():
    lines, witness, _ = mul_chain(6, 5)
    program = Program.from_strs(lines, 8)
    shifted = {k: v + (Q if i % 2 else -2 * Q) for i, (k, v) in enumerate(witness.items())}
    assert any(v < 0 for v in shifted.values()) and any(v >= Q for v in shifted.values())
    host, dev, _, _ = _proofs(program, shifted)
    assert dev == host == _proofs(program, witness)[0]


@pytest.mark.parametrize("case", CASES)
def test_the_gather_equals_the_host_loop(case):
    lines, witness, n = _circuit(case)
    program = Program.from_strs(lines, n)
    table = program.wire_table()
    assert program.wire_table() is table  # built once a program
    assert sorted(table.names) == sorted({v for c in program.constraints for v in c.wires.to_list()} - {None})
    assert (table.index[:, len(program.constraints):] == len(table.names)).all()  # padding reads the zero slot
    m = get_metrics()
    m.reset()
    cols = TorchEngine("cpu").wire_columns(table, witness)
    assert m.counters["device_columns"] == 3
    m.reset()
    assert [c.basis for c in cols] == [Basis.LAGRANGE] * 3
    assert [c.values for c in cols] == _host_columns(program, witness)
    host = HostEngine().wire_columns(table, witness)
    assert [(c.basis, c.values) for c in host] == [(c.basis, c.values) for c in cols]
    assert "device_columns" not in m.counters


@pytest.mark.parametrize("engine", [HostEngine, HostCommits])
def test_a_missing_variable_names_itself_and_its_row(engine):
    lines, witness, _ = mul_chain(8, 3)
    program = Program.from_strs(lines, 8)
    del witness["x3"]  # first met in column a at row 4 (x4 <== x3 * x3 + x3)
    with pytest.raises(KeyError) as err:
        Prover(_setup(8), program, engine() if engine is HostEngine else engine("cpu")).prove(
            witness, blinding=BLINDING)
    assert err.value.args[0] == "witness missing variable 'x3' (constraint row 4)"


def test_two_proves_of_one_dict_changed_in_place_each_prove_its_values():
    lines, witness, _ = mul_chain(6, 5)
    program = Program.from_strs(lines, 8)
    prover = Prover(_setup(8), program, HostCommits("cpu"))
    first = prover.prove(witness, blinding=BLINDING).to_bytes()
    assert first == _proofs(program, dict(witness))[0]
    _, again, _ = mul_chain(6, 9)
    witness.update(again)  # the same dict object, new values
    second = prover.prove(witness, blinding=BLINDING).to_bytes()
    assert second != first
    assert second == _proofs(program, dict(witness))[0]


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
def test_sparse_equals_the_packed_list(extra):
    n = 8
    length = n + extra
    entries = {0: Q - 1, 1: -3, n - 1: 2 * Q + 7, length - 1: 5}
    values = [0] * length
    for i, v in entries.items():
        values[i] = v % Q
    for basis in (Basis.MONOMIAL, Basis.LAGRANGE):
        got = DPoly.sparse(length, entries, basis, "cpu")
        assert (got.basis, got.values) == (basis, DPoly.from_ints(values, basis, "cpu").values)
        host = HostEngine().sparse_poly(length, entries, basis)
        assert (host.basis, host.values) == (basis, values)
    assert DPoly.sparse(length, {}, Basis.MONOMIAL, "cpu").values == [0] * length
