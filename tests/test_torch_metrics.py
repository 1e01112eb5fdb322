"""The port's recorder of spans and counters (``baby_plonk_tpu_torch/utils/
metrics.py``) on the CPU.

A span keeps a record and opens a profiler range only while
``torch.profiler`` records (or ``keep_records`` is set); every span of a
prove carries that prove's id, inside its parent's interval; ``h2d_bytes``
counts the bytes that go to the device and ``host_syncs`` the times the
host waits for it, the same for every prove of one witness.

The proves run on ``TorchEngine("cpu")`` at 8 gates with the commits' MSM
replaced by the identity: its plain version takes seconds a commit here,
and nothing the recorder does depends on the points.
"""
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from baby_plonk_tpu_torch import native
from baby_plonk_tpu_torch.circuits.library import mul_chain
from baby_plonk_tpu_torch.ops import g1_vec, limbs
from baby_plonk_tpu_torch.ops.limbs import FR
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup
from baby_plonk_tpu_torch.utils import metrics

N = 8
#: the spans this recorder's callers open besides the rounds, ``prover.intt`` and ``prover.commit``
NEW_SPANS = ("prover.prepare", "prover.columns", "dpoly.from_ints", "prover.transcript", "program.from_strs",
             "program.preprocess")


class IdentityCommits(TorchEngine):
    """Every commitment is the identity; everything around the MSM runs."""

    def _commit_arrays(self, setup, scalars_raw):
        return g1_vec.pidentity((len(scalars_raw),), self.device)


def _prover():
    lines, witness, _ = mul_chain(N, 1234567)
    setup = Setup.generate_srs(N + 6, 0xDEADBEEF, cache=False)
    return Prover(setup, Program.from_strs(lines, N), IdentityCommits("cpu")), witness


def _ranges(prof) -> list[str]:
    """The names of a profile's host events (``prof.events()`` takes 20 s here)."""
    return [e.name() for e in prof.profiler.kineto_results.events()]


@pytest.fixture(scope="module")
def traced():
    """The program's set-up under a CPU profiler, a cold prove, then two
    warm proves of the same witness under another. Returns the recorder's
    records, the profiles' range names, and for each prove the ids its spans
    carry, its slice of the records, the counters it added and the (shape,
    dtype) of each host tensor it copied to the device; then the prover."""
    m = metrics.get_metrics()
    m.reset()
    with profile(activities=[ProfilerActivity.CPU]) as setup_prof:
        prover, witness = _prover()
    proves = []
    to_device = limbs.to_device

    def prove():
        first, before, uploads = len(m.records), dict(m.counters), []
        limbs.to_device = lambda host, *a, **k: uploads.append((tuple(host.shape), host.dtype)) or to_device(host, *a, **k)
        try:
            prover.prove(witness, blinding=list(range(1, 12)))
        finally:
            limbs.to_device = to_device
        added = {k: v - before.get(k, 0) for k, v in m.counters.items()}
        proves.append(({r.proof for r in m.records[first:]}, slice(first, len(m.records)), added, uploads))

    prove()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prove()
        prove()
    records = list(m.records)
    m.reset()
    return records, _ranges(setup_prof) + _ranges(prof), proves, prover


def test_untraced_spans_keep_no_record_open_no_range_and_read_no_environment(monkeypatch):
    reads, ranges = [], []

    class Environ(dict):
        def __getitem__(self, key):
            reads.append(key)
            return super().__getitem__(key)

        def get(self, key, default=None):
            reads.append(key)
            return super().get(key, default)

    m = metrics.get_metrics()
    m.reset()
    monkeypatch.setattr(metrics, "record_function", lambda name: ranges.append(name))
    monkeypatch.setattr(os, "environ", Environ(os.environ))
    with m.span("outer"), m.span("inner"):
        pass
    assert reads == []
    monkeypatch.undo()
    monkeypatch.setattr(metrics, "record_function", lambda name: ranges.append(name))
    prover, witness = _prover()
    prover.prove(witness, blinding=list(range(1, 12)))
    assert not torch.autograd._profiler_enabled()
    assert m.records == [] and ranges == []
    assert {"outer", "inner", "prover.round_1", "prover.columns", "dpoly.from_ints"} <= set(m.durations)
    m.reset()


def test_keep_records_without_a_profiler(monkeypatch):
    m = metrics.get_metrics()
    m.reset()
    monkeypatch.setattr(m, "keep_records", True)
    with m.span("outer"):
        with m.proof() as pid, m.span("inner"):
            pass
    (outer, inner) = m.records
    assert (outer.name, outer.proof, outer.parent) == ("outer", None, None)
    assert (inner.name, inner.proof, inner.parent) == ("inner", pid, 0)
    m.reset()
    assert m.records == [] and not m.durations and not m.counters


def test_every_span_of_a_prove_carries_its_id(traced):
    records, _, proves, _ = traced
    assert proves[0][0] == set()  # untraced
    ids = [p[0] for p in proves[1:]]
    assert all(len(i) == 1 and None not in i for i in ids)
    assert len(set().union(*ids)) == 2
    assert {r.proof for r in records[: proves[0][1].start]} == {None}  # set-up
    assert {r.name for r in records[: proves[0][1].start]} == {"program.from_strs", "program.preprocess"}


def test_children_lie_inside_their_parents(traced):
    records, _, proves, _ = traced
    children = [r for r in records if r.parent is not None]
    # nine a traced prove: round 1's pack (the native read of the witness in
    # the order the cold prove taught), its gather, its iNTT and its commit;
    # rounds 2 and 3's iNTT and commit; round 5's commit. Without the native
    # reader round 1 also opens the lookups' column span and a second pack.
    hits = sum(p[2].get("witness_order_hits", 0) for p in proves[1:])
    assert hits == (2 if native.witness_reader() else 0)
    assert len(children) == 2 * 9 + 2 * (2 - hits)
    for r in children:
        p = records[r.parent]
        assert p.start <= r.start <= r.end <= p.end and p.proof == r.proof, (r, p)


@pytest.mark.parametrize("name", NEW_SPANS)
def test_each_new_span_is_a_record_and_a_range(traced, name):
    records, ranges, _, _ = traced
    kept = sum(r.name == name for r in records)
    assert kept >= 1 and ranges.count(name) == kept


def test_round_1_packs_its_columns_and_blinding_under_its_span(traced):
    records, _, proves, prover = traced
    inside = records[proves[-1][1]]
    round1 = [i for i, r in enumerate(records) if r.name == "prover.round_1" and r.proof in proves[-1][0]]
    assert len(round1) == 1
    # the witness is read once by the native pass in the learned order, then
    # gathered; without the native reader the pass returns at once and the
    # lookups, the pack and the gather follow: all children of round 1, in
    # that order. The blinding is made on the device (DPoly.sparse) and packs
    # nothing
    spans = [r for r in inside if r.name in ("dpoly.from_ints", "prover.columns")]
    assert all(r.parent == round1[0] for r in spans)
    assert all(a.end <= b.start for a, b in zip(spans, spans[1:]))
    order = ["dpoly.from_ints", "prover.columns"]
    hit = proves[-1][2].get("witness_order_hits", 0) == 1
    assert hit == (native.witness_reader() is not None)
    assert [r.name for r in spans] == (order if hit else order * 2)
    assert sum(r.name == "prover.transcript" for r in inside) == 5
    # a warm prove uploads the witness once and otherwise a few scalars a
    # call: as packed rows of 16 int16 limbs, 32 bytes a value, the witness
    # and round 5's 15 coefficients; as int32 limb columns, 64 bytes a value,
    # the public input 1, round 1's blinding 12, round 2's 4 constants and 6
    # blinding, round 3's 6 constants, z's shift 1, the cross-blinding 2 + 2,
    # round 4's point 1, round 5's constant 1, the debug check's point 1, two
    # divisions by (x - z) 4 each and z - z_omega_bar's constant 1
    V = len(prover.program.wire_table().names)
    uploads = proves[-1][3]
    assert [u for u in uploads if u[1] == torch.int16] == [((V, 16), torch.int16), ((15, 16), torch.int16)]
    scalars = [shape for shape, dtype in uploads if dtype != torch.int16]
    assert all(len(s) == 2 and s[0] == 16 and 1 <= s[1] <= 6 for s in scalars), scalars
    assert sum(s[1] for s in scalars) == 46
    assert proves[-1][2]["h2d_bytes"] == 32 * (V + 15) + 64 * 46


def test_two_proves_of_one_witness_count_the_same(traced):
    _, _, proves, _ = traced
    warm = [p[2] for p in proves[1:]]
    assert warm[0] == warm[1] and warm[0]["h2d_bytes"] > 0 and warm[0]["host_syncs"] > 0
    assert proves[0][2]["h2d_bytes"] > warm[0]["h2d_bytes"]  # the cold prove also packs the key's caches


def test_the_host_engine_opens_round_1s_column_span_and_counts_no_device_work(monkeypatch):
    """``HostEngine.wire_columns`` opens ``prover.columns`` once under round
    1, as the device engines do; nothing goes to a device or waits for one."""
    from baby_plonk_tpu_torch.ops.engine import HostEngine

    m = metrics.get_metrics()
    m.reset()
    monkeypatch.setattr(m, "keep_records", True)
    prover, witness = _prover()
    prover.engine = HostEngine()
    prover.prove(witness, blinding=list(range(1, 12)))
    records = list(m.records)
    counters = dict(m.counters)
    m.reset()
    (round1,) = [i for i, r in enumerate(records) if r.name == "prover.round_1"]
    assert [r.parent for r in records if r.name == "prover.columns"] == [round1]
    assert not {"h2d_bytes", "host_syncs", "device_columns"} & set(counters)


@pytest.mark.parametrize("case, h2d_bytes, host_syncs", [
    ("pack_raw 1", 64, 1),
    ("pack_raw 37", 64 * 37, 1),
    ("unpack_raw 37", 0, 1),
    ("mont_scalar", 64, 1),
    ("const", 64, 1),
    ("const again", 0, 0),
])
def test_codec_counts(case, h2d_bytes, host_syncs):
    packed = FR.pack_raw(list(range(37)), "cpu")
    value = 0xC0FFEE00 + len(case)  # a constant no other test caches
    calls = {
        "pack_raw 1": lambda: FR.pack_raw([5], "cpu"),
        "pack_raw 37": lambda: FR.pack_raw(list(range(37)), "cpu"),
        "unpack_raw 37": lambda: FR.unpack_raw(packed),
        "mont_scalar": lambda: FR.mont_scalar(7, "cpu"),
        "const": lambda: FR.const(value, "cpu"),
        "const again": lambda: FR.const(value, "cpu"),
    }
    if case == "const again":
        FR.const(value, "cpu")
    m = metrics.get_metrics()
    m.reset()
    calls[case]()
    assert (m.counters.get("h2d_bytes", 0), m.counters.get("host_syncs", 0)) == (h2d_bytes, host_syncs)
    m.reset()
