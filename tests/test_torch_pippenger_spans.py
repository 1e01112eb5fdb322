"""The variable-base Pippenger MSM's span and counters (``ops/
msm_pippenger.py``, ``utils/metrics.py``) on the CPU.

A prove of the 8-gate chain through ``TorchEngine("cpu")`` with every
commit by the Pippenger (its plain version) counts one ``pippenger_msms``
a nonzero commit, 9 a prove, and their points in ``pippenger_points``; with
records kept, each ``msm.pippenger`` record carries its size and lies under
a ``prover.commit``. The fixed-base default counts none.
"""
import pytest

from baby_plonk_tpu_torch import config
from baby_plonk_tpu_torch.circuits.library import mul_chain
from baby_plonk_tpu_torch.ops import msm_pippenger
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup
from baby_plonk_tpu_torch.utils import metrics

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

N = 8
COUNTERS = ("pippenger_msms", "pippenger_points")


def _prove(**kw):
    """One prove under ``Config(**kw)`` with records kept: (the counters it
    added, its records, the length of each plain Pippenger call's points)."""
    lines, witness, _ = mul_chain(N, 7654321)
    setup = Setup.generate_srs(N + 6, 0xDEADBEEF, cache=False)
    prover = Prover(setup, Program.from_strs(lines, N), TorchEngine("cpu"))
    prev, plain, lengths = config.get_config(), msm_pippenger.msm_pippenger_plain, []
    m = metrics.get_metrics()
    m.reset()
    m.keep_records = True
    config.set_config(config.Config(**kw))
    msm_pippenger.msm_pippenger_plain = lambda points, *a, **k: lengths.append(points[0].shape[-1]) or plain(
        points, *a, **k)
    try:
        prover.prove(witness, blinding=list(range(1, 12)))
        return {k: m.counters.get(k, 0) for k in COUNTERS}, list(m.records), lengths
    finally:
        msm_pippenger.msm_pippenger_plain = plain
        config.set_config(prev)
        m.keep_records = False
        m.reset()


@pytest.fixture(scope="module")
def pippenger_prove():
    return _prove(commit_fixed_base=False, msm_algorithm="pippenger")


def test_one_call_a_nonzero_commit(pippenger_prove):
    counters, _, lengths = pippenger_prove
    # a, b, c, z, t_lo, t_mid, t_hi, W_zeta, W_zeta_omega
    assert len(lengths) == 9 and all(1 <= k <= N + 6 for k in lengths)
    assert counters == {"pippenger_msms": 9, "pippenger_points": sum(lengths)}


def test_each_call_is_a_sized_record_under_a_commit(pippenger_prove):
    _, records, lengths = pippenger_prove
    calls = [r for r in records if r.name == "msm.pippenger"]
    assert [r.size for r in calls] == lengths
    for r in calls:
        parents = []
        while r.parent is not None:
            r = records[r.parent]
            parents.append(r.name)
        assert parents[0] == "prover.commit" and parents[-1].startswith("prover.round_"), parents


def test_the_fixed_base_default_counts_none():
    counters, records, lengths = _prove()
    assert counters == dict.fromkeys(COUNTERS, 0) and lengths == []
    assert not [r for r in records if r.name == "msm.pippenger"]
    assert any(r.name == "prover.commit" for r in records)


@pytest.mark.parametrize("size", [None, 0, 65538])
def test_span_keeps_the_size_it_is_given(monkeypatch, size):
    m = metrics.get_metrics()
    m.reset()
    monkeypatch.setattr(m, "keep_records", True)
    with m.span("outer") if size is None else m.span("outer", size=size):
        pass
    (rec,) = m.records
    assert rec.size == size and m.durations["outer"] >= 0
    m.reset()
