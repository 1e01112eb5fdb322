"""CPU tests of a run: the reference against the port's exact host engine,
a cell added as new files only, and the faults under the timed path that
``correct`` must catch.

    python -m pytest -q plonkbench/tests

A run on the CPU proves with the kernels' plain versions (about 10 s a
proof at 8 gates), so the cells here are the 8-gate chain. The test marked
``gpu`` runs the real cell on the card and skips without one.
"""
import hashlib
import io
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from plonkbench.tests.small import small_root  # noqa: E402


@pytest.fixture(scope="module")
def host_proof():
    """A proof of the 8-gate chain by the port's exact host engine."""
    from baby_plonk_tpu_torch.circuits.library import mul_chain
    from baby_plonk_tpu_torch.ops.engine import HostEngine
    from baby_plonk_tpu_torch.protocol import Program, Prover, Setup

    lines, witness, public = mul_chain(8, 1234567)
    setup = Setup.generate_srs(14, 0xDEADBEEF, cache=False)
    blinding = [3 ** i + 5 for i in range(11)]
    proof = Prover(setup, Program.from_strs(lines, 8), HostEngine()).prove(witness, blinding=blinding)
    return lines, witness, public, blinding, proof.to_bytes()


def test_reference_accepts_the_host_engines_proof(host_proof):
    from plonkbench.reference.plonk import Prepared, check

    lines, witness, public, blinding, proof = host_proof
    assert check(Prepared.compute(lines, 8, 0xDEADBEEF), proof, witness, blinding, public) == []


def test_reference_rejects_a_changed_public_input(host_proof):
    from plonkbench.reference.plonk import Prepared, check

    lines, witness, public, blinding, proof = host_proof
    witness = dict(witness, pub=(witness["pub"] + 1))
    bad = check(Prepared.compute(lines, 8, 0xDEADBEEF), proof, witness, blinding, [public[0] + 1])
    assert "w_zeta_1" in bad


@pytest.mark.parametrize("element", range(6))
def test_reference_rejects_a_changed_evaluation(host_proof, element):
    from plonkbench.reference.plonk import SCALARS, Prepared, check

    lines, witness, public, blinding, proof = host_proof
    at = 9 * 48 + 32 * element
    changed = proof[:at] + bytes([proof[at] ^ 1]) + proof[at + 1:]
    bad = check(Prepared.compute(lines, 8, 0xDEADBEEF), changed, witness, blinding, public)
    assert SCALARS[element] in bad


def test_reference_rejects_other_blinding(host_proof):
    from plonkbench.reference.plonk import Prepared, check

    lines, witness, public, blinding, proof = host_proof
    bad = check(Prepared.compute(lines, 8, 0xDEADBEEF), proof, witness, blinding[:8] + [1, 2, 3], public)
    assert "z_1" in bad and "a_1" not in bad


def test_reference_cache_reads_back_what_it_computed(tmp_path):
    from plonkbench.circuits import mul_chain
    from plonkbench.reference.plonk import Prepared

    lines = mul_chain.lines(16)
    made = Prepared.cached(lines, 32, 99, str(tmp_path))
    read = Prepared.cached(lines, 32, 99, str(tmp_path))
    assert len(os.listdir(tmp_path)) == 1
    for attr in ("n", "tau", "wires", "public", "sigma", "q_tau", "s_tau", "d_tau"):
        assert getattr(made, attr) == getattr(read, attr)


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            if "__pycache__" not in path and ".cache" not in path:
                out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


GENERATOR = '''"""One witness for every request, from the seed."""
import importlib.util, os, sys
spec = importlib.util.spec_from_file_location("closed_prove_base", os.path.join(os.path.dirname(__file__), "closed_prove.py"))
base = importlib.util.module_from_spec(spec)
sys.modules["closed_prove_base"] = base
spec.loader.exec_module(base)


class Traffic(base.Traffic):
    def __init__(self, mix, seed, circuit, gates):
        super().__init__(dict(mix, pool=1), seed, circuit, gates)
'''
READER = '''"""proofs_in_window: the proofs the traced window completed."""


def read(run):
    return run.proofs
'''
FAMILY = '''"""The multiply chain under another family name."""
from plonkbench.circuits.mul_chain import instance, lines  # noqa: F401
'''


def test_a_cell_added_as_new_files_runs(tmp_path):
    """A configuration, a circuit family, a traffic kind and its mix, a cell
    and a per-layer metric added as new files and BENCHMARK.json entries:
    no file that was there changes, and the traced run reports the new
    metric, correct."""
    import torch

    from plonkbench.harness import run_cell

    torch.set_num_threads(1)
    root = small_root(tmp_path)
    before = _digests(root)
    pb = os.path.join(root, "plonkbench")
    config = json.load(open(os.path.join(pb, "configs", "small.json")))
    config.update(name="small2", circuit={"family": "chain2", "gates": 8})
    new = {"configs/small2.json": json.dumps(config), "circuits/chain2.py": FAMILY,
           "traffic/same_witness.py": GENERATOR,
           "traffic/same1.json": json.dumps({"generator": "same_witness", "clients": 1, "pool": 1, "check_sample": 1}),
           "layers/proofs_in_window.py": READER}
    for rel, text in new.items():
        with open(os.path.join(pb, rel), "w") as f:
            f.write(text)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append({"name": "small2", "source": "https://github.com/ChainUpZero/baby-plonk-rust",
                             "file": "plonkbench/configs/small2.json", "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "small2-same", "config": "small2", "traffic": "same1", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "proofs_in_window", "unit": "proofs", "better": "higher", "source": "host_clock",
                               "layer": "protocol", "moves": "prove_s", "workloads": ["small2-same"]})
    for m in bench["end_to_end"]:
        if m["name"] == "prove_s":
            m["workloads"].append("small2-same")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = io.StringIO()
    assert run_cell(root, "small2-same", 2**41 + 9, 0.1, True, device="cpu", out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["metrics"]["proofs_in_window"]["value"] == 1.0
    assert list(line)[-1] == "checks" and "breakdown" in line
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == {k: v for k, v in before.items() if k != "BENCHMARK.json"} | {
        "BENCHMARK.json": after["BENCHMARK.json"]}


def test_faults_under_the_timed_path_are_not_correct(tmp_path):
    """The sound program is correct; a proof made without its blinding (the
    control), one whose t is split without its blinding, a stale proof
    returned again, and a proof altered where it is made are not."""
    import torch

    from plonkbench.harness import FAULTS, Run, Session, is_correct
    from plonkbench.spec import Cell

    torch.set_num_threads(1)
    session = Session(Cell(small_root(tmp_path), "small-prove"), "cpu")
    verdicts = {}
    for i, fault in enumerate((None,) + FAULTS):
        traffic = session.traffic(2**40 + i)
        serve = session.serve_fn(traffic, fault)
        session.warm(traffic, serve)
        records = session.window(traffic, serve, 0.1, Run())
        verdicts[fault] = is_correct(session.judge(traffic, records))
    assert verdicts == {None: True, "unblinded": False, "unsplit": False, "stale": False, "altered": False}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_p16_cell_runs_correct_on_the_card(card):
    r = subprocess.run([sys.executable, "plonkbench/run.py", "--workload", "p16-prove", "--seed", str(2**33 + 1),
                        "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_reference_checks_t_split_one_piece_at_a_time(host_proof):
    """With ``split`` the reference sees b10 and b11, which cancel in both
    linear checks of t."""
    from plonkbench.reference.plonk import Prepared, check

    lines, witness, public, blinding, proof = host_proof
    prep = Prepared.compute(lines, 8, 0xDEADBEEF)
    assert check(prep, proof, witness, blinding, public, split=True) == []
    other = blinding[:9] + [blinding[9] + 1, blinding[10]]
    assert check(prep, proof, witness, other, public) == []
    assert check(prep, proof, witness, other, public, split=True) == ["t_lo_1", "t_mid_1"]


@pytest.mark.parametrize("size", [8, 16, 64])
def test_reference_transforms_match_the_plain_sums(size):
    import random

    from plonkbench.reference import fr, ntt

    rng = random.Random(size)
    values = [rng.randrange(fr.Q) for _ in range(size)]
    w = fr.root_of_unity(size)
    want = [sum(v * pow(w, i * j, fr.Q) for i, v in enumerate(values)) % fr.Q for j in range(size)]
    assert list(ntt.ntt(values, w)) == want and list(ntt.intt(want, w)) == values
    coeffs = list(ntt.intt(values, w))
    big = fr.root_of_unity(4 * size)
    at = [7 * pow(big, j, fr.Q) % fr.Q for j in range(4 * size)]
    assert list(ntt.coset_values(values, 4, 7)) == [
        sum(c * pow(x, i, fr.Q) for i, c in enumerate(coeffs)) % fr.Q for x in at]


def _records(witnesses):
    from plonkbench.traffic.closed_prove import Record, Request

    return [Record(Request(i, w, [1] * 11), i, i + 1, b"p", None) for i, w in enumerate(witnesses)]


@pytest.mark.parametrize("seed", [1, 2**33 + 5, 2**31 + 77])
def test_sample_holds_first_last_and_every_witness(seed):
    from plonkbench.traffic.closed_prove import Traffic

    traffic = Traffic.__new__(Traffic)
    traffic.mix, traffic.seed, traffic.pool = {"check_sample": 5, "split_sample": 2}, seed, [None] * 4
    records = _records([0] * 60 + [1] + [2] * 60 + [3] + [0] * 10)
    sample = traffic.sample(records)
    idx = [r.request.index for r, _ in sample]
    assert idx == sorted(idx) and idx[0] == 0 and idx[-1] == len(records) - 1
    assert {r.request.witness for r, _ in sample} == {0, 1, 2, 3} and len(sample) == 5
    assert sum(split for _, split in sample) == 2
    assert sample == traffic.sample(records)


def test_p90_needs_fifty_proofs():
    from plonkbench.harness import Run
    from plonkbench.spec import load_module

    reader = load_module(os.path.join(ROOT, "plonkbench", "end_to_end", "prove_p90_s.py"), "p90_test")
    with pytest.raises(ValueError, match="50 proofs"):
        reader.read(Run(latencies=[1.0] * 49))
    assert reader.read(Run(latencies=[float(i) for i in range(1, 101)])) == pytest.approx(90.1)
