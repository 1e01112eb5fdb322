"""CPU tests of the benchmark's files: the contract's names and units, that
every name a cell uses is found as a file, the frozen work count against
the port's, and what the harness and the reference may import.

    python -m pytest -q plonkbench/tests
"""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "plonkbench/run.py"] and BENCH["paths"] == ["plonkbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + metrics(), ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_names_are_unique_and_metrics_well_formed():
    for group in (BENCH["configs"], BENCH["workloads"], metrics()):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_name_of_a_cell_is_found(cell):
    from plonkbench.spec import Cell

    c = Cell(ROOT, cell["name"])
    assert cell["chips"] == 1 and c.config["env"].get("BPT_ENGINE", "torch") == "torch"
    assert "chips" not in c.config and "engine" not in c.config
    config = next(x for x in BENCH["configs"] if x["name"] == cell["config"])
    assert config["file"].startswith("plonkbench/") and c.config["name"] == config["name"]
    assert c.config["reduced"] == config["reduced"]
    assert hasattr(c.generator(), "Traffic") and hasattr(c.circuit(), "instance")
    for trace in (False, True):
        readers = c.readers(trace)
        assert readers and all(callable(mod.read) for _, mod in readers)
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported


def test_every_config_is_used_and_files_distinct():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_frozen_mul_chain_is_the_ports():
    import random

    from baby_plonk_tpu_torch.circuits.library import mul_chain as port_mul_chain
    from plonkbench.circuits import mul_chain

    for gates in (3, 8, 64):
        witness, public = mul_chain.instance(gates, random.Random(7))
        x0 = random.Random(7).randrange(mul_chain.Q)
        assert mul_chain.lines(gates) == port_mul_chain(gates, x0)[0]
        assert (witness, public) == port_mul_chain(gates, x0)[1:]


@pytest.mark.parametrize("P, k, chunk, sms", [(3, 1000, 256, 132), (1, 4099, 1024, 132), (2, 2051, 16384, 4),
                                              (3, 16390, 16384, 132)])
def test_frozen_work_count_is_the_ports(P, k, chunk, sms):
    """With every scalar bit set, no table index is 0: the port's count of
    this run's nonzero indices then equals the frozen count's."""
    import torch

    from baby_plonk_tpu_torch.ops import msm_fixed
    from baby_plonk_tpu_torch.utils import roofline as port
    from plonkbench.work import roofline

    tabs = msm_fixed.FixedBaseTables(tuple(torch.zeros((24, k), dtype=torch.int32) for _ in range(3)), chunk=chunk)
    full, rest = tabs.launch_groups(k)
    G = full * (chunk // 8) + rest
    assert G == roofline.launch_groups(k, chunk)
    W = roofline.windows_for(P * G, sms)
    sc = torch.full((16, P, 8 * G), 0xFFFF, dtype=torch.int32)
    assert roofline.horner_work(P, k, chunk, sms) == port.horner_work(sc, G, W)
    assert (roofline.MEM_BYTES_PER_S, roofline.INT_MAD_PER_S) == (port.MEM_BYTES_PER_S, port.INT_MAD_PER_S)
    assert roofline.bound_s(*port.horner_work(sc, G, W)) * 1e3 == pytest.approx(port.bound(*port.horner_work(sc, G, W))[0])


_BLOCKER = """
import sys
class Block:
    def __init__(self, names): self.names = set(names)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.names:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block({blocked!r}))
sys.path.insert(0, {root!r})
"""


def _child(blocked, body):
    code = _BLOCKER.format(blocked=blocked, root=ROOT) + body
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    return r.stdout


def test_reference_imports_nothing_of_the_port_or_torch():
    out = _child(["jax", "jaxlib", "flax", "baby_plonk_tpu", "baby_plonk_tpu_torch", "torch"], """
import plonkbench.reference.plonk, plonkbench.reference.g1, plonkbench.reference.transcript
import plonkbench.reference.assembly, plonkbench.reference.fr, plonkbench.circuits.mul_chain, plonkbench.work.roofline
print(sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "flax", "baby_plonk_tpu", "baby_plonk_tpu_torch", "torch"}))
""")
    assert out.strip().splitlines()[-1] == "[]"


def test_a_run_imports_no_jax(tmp_path):
    """A whole CPU run of a small cell, in a child in which jax, jaxlib,
    flax and baby_plonk_tpu (whole top-level names) cannot be imported."""
    from plonkbench.tests.small import small_root

    root = small_root(tmp_path)
    out = _child(["jax", "jaxlib", "flax", "baby_plonk_tpu"], f"""
import torch
torch.set_num_threads(1)
import plonkbench.run, plonkbench.readings
from plonkbench.harness import run_cell, forbidden_modules
rc = run_cell({str(root)!r}, "small-prove", 2**40 + 3, 0.1, False, device="cpu")
print("rc", rc, forbidden_modules())
""")
    lines = out.strip().splitlines()
    assert lines[-1] == "rc 0 []"
    assert json.loads(lines[-2])["correct"] is True
