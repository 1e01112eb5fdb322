"""CPU tests of the ``p16pip-prove`` cell's files: the small cell under the
Pippenger configuration's switches runs correct with the plain Pippenger and
fails under the fault controls, the frozen work count equals the port's on
saturated digits, and the two readers find nothing to read where there is
nothing.

    python -m pytest -q plonkbench/tests/test_plonkbench_pippenger.py
"""
import io
import json
import os
import sys
from types import SimpleNamespace

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from plonkbench.tests.small import small_root  # noqa: E402

READERS = ("pippenger_roofline", "pippenger_ms")


def _pip_root(tmp_path) -> str:
    """The small cell's copy, its configuration's switches those of ``plonk16-mulchain-pip``."""
    root = small_root(tmp_path)
    path = os.path.join(root, "plonkbench", "configs", "small.json")
    config = json.load(open(path))
    config["env"] = json.load(open(os.path.join(ROOT, "plonkbench", "configs", "plonk16-mulchain-pip.json")))["env"]
    with open(path, "w") as f:
        json.dump(config, f)
    return root


def test_the_small_cell_under_the_pippenger_switches(tmp_path):
    """A traced run is correct, commits by the Pippenger only, and reports
    neither reader (no kernel in a CPU trace); a proof made without its
    blinding and a stale proof are not correct."""
    import torch

    from baby_plonk_tpu_torch.utils.metrics import get_metrics
    from plonkbench.harness import Run, Session, is_correct, run_cell
    from plonkbench.spec import Cell

    torch.set_num_threads(1)
    root = _pip_root(tmp_path)
    out = io.StringIO()
    assert run_cell(root, "small-prove", 2**41 + 23, 0.1, True, device="cpu", out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert not set(READERS) & set(line["metrics"])
    m = get_metrics()
    calls = [r for r in m.records if r.name == "msm.pippenger"]
    assert m.counters["pippenger_msms"] == len(calls) == 9 * line["attempted"]
    assert all(r.size is not None for r in calls)
    session = Session(Cell(root, "small-prove"), "cpu")
    verdicts = {}
    for i, fault in enumerate(("unblinded", "stale")):
        traffic = session.traffic(2**40 + 31 + i)
        serve = session.serve_fn(traffic, fault)
        session.warm(traffic, serve)
        records = session.window(traffic, serve, 0.1, Run())
        verdicts[fault] = is_correct(session.judge(traffic, records))
    assert verdicts == {"unblinded": False, "stale": False}


def _saturated(n: int, tops: list):
    """(nwin, n) sorted digits: none zero, as many distinct as fit, the top at its maximum."""
    import torch

    ar = torch.arange(n, dtype=torch.int64)
    return torch.stack([torch.sort(ar % d + max(1, d - n + 1)).values for d in tops])


@pytest.mark.parametrize("n", [2**10, 65538, 2**20 + 6])
def test_frozen_work_count_is_the_ports(n):
    from baby_plonk_tpu_torch.ops import msm_pippenger
    from baby_plonk_tpu_torch.utils import roofline as port
    from plonkbench.work import pippenger, roofline

    c = pippenger.window_c(n)
    assert (c, pippenger.windows(c)) == (msm_pippenger.window_c(n), msm_pippenger.windows(c))
    tops = pippenger.top_digits(n)
    ds = _saturated(n, tops)
    assert ds.max(dim=1).values.tolist() == tops and bool((ds != 0).all())
    assert pippenger.pippenger_work(n) == port.pippenger_work(ds, c)
    assert pippenger.pippenger_bound_s(n) * 1e3 == pytest.approx(port.bound(*port.pippenger_work(ds, c))[0])
    assert pippenger.ADD_MULS == port.ADD_MULS and roofline.DOUBLE_MADS == port.DOUBLE_MADS
    if n == 65538:
        assert tops[-1] == 7 and len(tops) == 19


def _reader(name):
    from plonkbench.spec import load_module

    return load_module(os.path.join(ROOT, "plonkbench", "layers", name + ".py"), f"test_{name}")


def _run(by_name: dict):
    from plonkbench.harness import Run
    from plonkbench.tracing import Trace

    return Run(proofs=2, trace=Trace(window_s=1.0, busy_s=0.5, device_ops=10, by_name=by_name))


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_without_the_kernels(monkeypatch, name):
    from baby_plonk_tpu_torch.utils.metrics import SpanRecord, get_metrics

    monkeypatch.setattr(get_metrics(), "records", [SpanRecord("msm.pippenger", 0, None, 0.0, 1.0, size=65538)])
    assert _reader(name).read(_run({"aten::add": (4, 0.1), "msm_fixed_kernel": (2, 0.2)})) is None


def test_readers_on_the_kernels_with_and_without_sizes(monkeypatch):
    from baby_plonk_tpu_torch.utils.metrics import SpanRecord, get_metrics
    from plonkbench.work import pippenger

    # two calls at 65,538 points, each the five kernels' times on an H100 (PERF.md's kernel table), 4.388 ms
    by_name = dict(zip(pippenger.KERNELS, [(2, 0.050e-3), (2, 1.898e-3), (2, 2.470e-3), (2, 0.090e-3), (2, 4.268e-3)]))
    run = _run(by_name)
    assert _reader("pippenger_ms").read(run) == pytest.approx(4.388)
    sized = [SpanRecord("msm.pippenger", 0, None, 0.0, 1.0, size=65538)] * 2
    monkeypatch.setattr(get_metrics(), "records", sized)
    share = _reader("pippenger_roofline").read(run)
    assert share == pytest.approx(100 * pippenger.pippenger_bound_s(65538) / 4.388e-3) and 5 < share < 10
    # the parent's records: no size field
    monkeypatch.setattr(get_metrics(), "records", [SimpleNamespace(name="msm.pippenger", start=0.0, end=1.0)])
    assert _reader("pippenger_roofline").read(run) is None
