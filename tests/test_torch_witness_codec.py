"""Round 1's witness read by one native pass over the dict in its own order
(``WireTable.learn`` / ``WireTable.packed``, csrc/host/witness.c), held on
the CPU against the path that reads it by one lookup a name and packs it
with ``FR.pack_mont``.

Each case teaches a fresh program's wire table a key order, then hands
``TorchEngine("cpu").wire_columns`` witnesses and compares the bytes it
uploads with those the lookup path uploads for the same witness (the
native reader switched off), the columns with a plain loop, and
the counters ``witness_order_hits`` / ``witness_order_misses`` with the
path each read should take. One prove is compared byte for byte with
``HostEngine``'s. The native cases skip only where the library cannot be
built.
"""
import random
import sys
import threading

import pytest

from baby_plonk_tpu_torch import native
from baby_plonk_tpu_torch.circuits.library import mul_chain
from baby_plonk_tpu_torch.fields import fr
from baby_plonk_tpu_torch.ops import limbs
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup
from baby_plonk_tpu_torch.protocol.poly import Poly
from baby_plonk_tpu_torch.utils.metrics import get_metrics

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

Q = fr.Q
N = 16
BLINDING = [Q - 1, 2, 3 * Q + 5, 4, 5, 6, 7, 8, 9, 10, 11]
needs_native = pytest.mark.skipif(native.witness_reader() is None, reason="the native witness reader cannot be built")


def _witness(x0: int, order=None, extra=None, edit=None) -> dict:
    """``mul_chain(N, x0)``'s witness with keys made anew (no key object
    shared with another call's dict), in ``order`` (a list of its keys),
    with the ``extra`` entries inserted at their positions and the values of
    ``edit`` put in."""
    _, w, _ = mul_chain(N, x0)
    w.update(edit or {})
    items = list(w.items()) if order is None else [(k, w[k]) for k in order]
    for at, (k, v) in sorted((extra or {}).items()):
        items.insert(at, (k, v))
    return {"".join(list(k)): v for k, v in items}


def _program():
    lines, _, _ = mul_chain(N, 1)
    return Program.from_strs(lines, N)


def _host_columns(program, witness):
    cols = [[0] * N for _ in range(3)]
    for i, c in enumerate(program.constraints):
        for j, name in enumerate(c.wires.to_list()):
            if name is not None:
                cols[j][i] = witness[name] % Q
    return cols


def _read(table, witness, monkeypatch, native_on=True):
    """``wire_columns`` on ``witness``: (the bytes it uploaded, the columns,
    (hits, misses) it counted)."""
    uploads = []
    to_device = limbs.to_device

    def spy(host, *a, **k):
        uploads.append(host.numpy().tobytes())
        return to_device(host, *a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(limbs, "to_device", spy)
        if not native_on:
            mp.setattr(native, "witness_reader", lambda: None)
        m = get_metrics()
        m.reset()
        cols = TorchEngine("cpu").wire_columns(table, witness)
        counts = (m.counters.get("witness_order_hits", 0), m.counters.get("witness_order_misses", 0))
        m.reset()
    return uploads[0], [c.values for c in cols], counts


def _today(witness, monkeypatch):
    """The bytes the lookup path uploads for ``witness``, on a table of its own."""
    return _read(_program().wire_table(), witness, monkeypatch, native_on=False)[0]


GENERATOR_ORDER = list(mul_chain(N, 1)[1])
SHUFFLED = random.Random(19).sample(GENERATOR_ORDER, len(GENERATOR_ORDER))
EDGES = {"x0": Q, "x1": Q + 7, "x2": 2 * Q + 5, "x3": (1 << 256) - 1, "x4": 1 << 256, "x5": (1 << 300) + 9,
         "x6": -1, "x7": -3 * Q - 4, "x8": True, "x9": 0}
#: case -> the witness of the chain from x0 in that form
CASES = {
    "own order": lambda x0: _witness(x0),
    "shuffled": lambda x0: _witness(x0, order=SHUFFLED),
    "extra keys": lambda x0: _witness(x0, extra={0: ("spare0", 5), 4: ("spare4", -2), 99: ("spare_end", 1 << 400)}),
    "edge values": lambda x0: _witness(x0, edit=EDGES),
}


@needs_native
@pytest.mark.parametrize("case", list(CASES))
def test_a_learned_order_is_read_natively_to_todays_bytes(case, monkeypatch):
    program = _program()
    table = program.wire_table()
    make = CASES[case]
    # the generator's order first: a miss that teaches it
    _, _, counts = _read(table, _witness(5), monkeypatch)
    assert counts == (0, 1)
    first, again = make(7), make(11)
    assert list(first) == list(again) and not set(map(id, first)) & set(map(id, again))
    up, cols, counts = _read(table, first, monkeypatch)
    # a new order is a miss, read by the lookups, and learned
    assert counts == ((1, 0) if case in ("own order", "edge values") else (0, 1))
    assert up == _today(first, monkeypatch) and cols == _host_columns(program, first)
    up, cols, counts = _read(table, again, monkeypatch)
    assert counts == (1, 0)
    assert up == _today(again, monkeypatch) and cols == _host_columns(program, again)
    assert table.packed(again).tobytes() == up
    # the same dict again: every key the learned object itself
    assert _read(table, again, monkeypatch)[::2] == (up, (1, 0))


@needs_native
@pytest.mark.parametrize("renamed", ["spare", "x3"])
def test_one_key_renamed_at_the_same_size_is_a_miss(renamed, monkeypatch):
    program = _program()
    table = program.wire_table()
    extra = {2: ("spare", 9)}
    _read(table, _witness(5, extra=extra), monkeypatch)
    w = _witness(7, extra=extra)
    w = {(k + "_" if k == renamed else k): v for k, v in w.items()}
    assert len(w) == len(table.order[0])
    assert table.packed(w) is None
    if renamed == "x3":  # a variable a wire reads: the lookups name it
        with pytest.raises(KeyError) as err:
            _read(table, w, monkeypatch)
        assert err.value.args[0] == "witness missing variable 'x3' (constraint row 4)"
        return
    up, cols, counts = _read(table, w, monkeypatch)
    assert counts == (0, 1)
    assert up == _today(w, monkeypatch) and cols == _host_columns(program, w)


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("fault, error", [
    ("missing", KeyError),
    ("a float", TypeError),
])
def test_a_bad_witness_fails_as_before(native_on, fault, error, monkeypatch):
    if native_on and native.witness_reader() is None:
        pytest.skip("the native witness reader cannot be built")
    table = _program().wire_table()
    _read(table, _witness(5), monkeypatch, native_on)
    w = _witness(7)
    if fault == "missing":
        del w["x3"]
    else:
        w["x3"] = 2.5
    got = []
    for on in (native_on, False):
        with pytest.raises(error) as err:
            _read(table if on else _program().wire_table(), w, monkeypatch, on)
        got.append(err.value.args)
    assert got[0] == got[1]
    if fault == "missing":
        assert got[0][0] == "witness missing variable 'x3' (constraint row 4)"


@pytest.mark.parametrize("case", ["no native reader", "a dict subclass"])
def test_todays_path_where_no_order_can_be_read(case, monkeypatch):
    """Without the native reader, or for a witness that is not a plain
    dict, every read is a miss and no order is learned."""
    program = _program()
    table = program.wire_table()
    on = case != "no native reader"
    make = (lambda x0: _witness(x0)) if not on else (lambda x0: type("Witness", (dict,), {})(_witness(x0)))
    for x0 in (5, 7):
        up, cols, counts = _read(table, make(x0), monkeypatch, native_on=on)
        assert counts == (0, 1)
        assert up == _today(dict(make(x0)), monkeypatch) and cols == _host_columns(program, make(x0))
    assert table.order is None


class HostCommits(TorchEngine):
    """TorchEngine("cpu") with every commitment made by the host MSM."""

    def commit_many(self, setup, polys):
        return [setup.commit(Poly(p.values, p.basis)) for p in polys]


@needs_native
def test_proofs_of_a_learned_order_equal_the_host_engines():
    program = _program()
    setup = Setup.generate_srs(N + 6, 0xDEADBEEF, cache=False)
    host = HostEngine()
    device = Prover(setup, program, HostCommits("cpu"))
    m = get_metrics()
    for x0, counts in [(5, (0, 1)), (7, (1, 0)), (11, (1, 0))]:
        w = _witness(x0)
        w["x2"] -= 2 * Q  # the same residues, as a negative, above Q and above 2^256
        w["x4"] += Q
        w["x5"] += 3 * Q
        m.reset()
        got = device.prove(w, blinding=BLINDING).to_bytes()
        assert (m.counters.get("witness_order_hits", 0), m.counters.get("witness_order_misses", 0)) == counts
        m.reset()
        assert got == Prover(setup, program, host).prove(w, blinding=BLINDING).to_bytes()


@needs_native
def test_threads_reading_in_two_orders_get_their_own_bytes():
    """Two orders fight over one table's learned order: each read is either
    a miss or its own witness's bytes, never the other order's."""
    table = _program().wire_table()
    forms = [(_witness(5), _witness(5, order=SHUFFLED)), (_witness(7, order=SHUFFLED), _witness(7))]
    want = [bytes(bytearray().join(int.to_bytes(v % Q, 32, "little") for v in table.values(w))) for w, _ in forms]
    errors, reads = [], [0, 0]

    def worker(i):
        try:
            for r in range(300):
                w = forms[i][r % 2]
                got = table.packed(w)
                if got is None:
                    table.values(w)
                    table.learn(w)
                else:
                    assert got.tobytes() == want[i]
                    reads[i] += 1
        except Exception as e:  # reported below: an assertion in a thread does not fail the test
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1, 0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and min(reads) > 0
