"""CPU tests of the ``p16ip-prove`` cell's files: the frozen
``circuits/inner_product.py`` against the port's ``inner_product``, its
rows under the reference's own parser, its imports; a small cell of the
configuration run correct and traced, and failing under the fault
controls.

    python -m pytest -q plonkbench/tests/test_plonkbench_inner_product.py
"""
import io
import json
import os
import random
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from plonkbench.tests.small import small_root  # noqa: E402

CONFIG = os.path.join(ROOT, "plonkbench", "configs", "plonk16-innerprod-fb.json")


def _pairs(gates: int, seed: int) -> list:
    """The pairs ``instance(gates, random.Random(seed))`` draws, in its order."""
    rng = random.Random(seed)
    return [(rng.randrange(256), rng.randrange(-128, 128)) for _ in range((gates - 2) // 2)]


@pytest.mark.parametrize("gates", [8, 66])
def test_frozen_inner_product_is_the_ports(gates):
    from baby_plonk_tpu_torch.circuits.library import inner_product as port_inner_product
    from plonkbench.circuits import inner_product

    witness, public = inner_product.instance(gates, random.Random(gates))
    lines, port_witness, port_public = port_inner_product(_pairs(gates, gates))
    assert inner_product.lines(gates) == lines and len(lines) == gates
    assert list(witness.items()) == list(port_witness.items()) and public == port_public
    assert len(witness) == 2 * gates - 3


@pytest.mark.parametrize("gates", [2, 3, 9])
def test_frozen_inner_product_refuses_odd_or_too_few_gates(gates):
    from plonkbench.circuits import inner_product

    with pytest.raises(ValueError, match="even number of gates"):
        inner_product.lines(gates)
    with pytest.raises(ValueError, match="even number of gates"):
        inner_product.instance(gates, random.Random(1))


def test_every_row_holds_under_the_reference_parser():
    """ql a + qr b + qm a b + qo c + qc, less the public value on a public
    row, is 0 on every row; the weights span both signs and the values
    the int8 ranges."""
    from plonkbench.circuits import inner_product
    from plonkbench.reference import assembly

    Q = inner_product.Q
    gates = 202
    witness, public = inner_product.instance(gates, random.Random(2**40 + 1))
    kinds = set()
    for line in inner_product.lines(gates):
        wires, (ql, qr, qm, qo, qc), pub = assembly.row(line)
        a, b, c = (0 if v is None else witness[v] for v in wires)
        kinds.add((ql, qr, qm, qo, qc))
        assert (ql * a + qr * b + qm * a * b + qo * c + qc - (witness[pub] if pub else 0)) % Q == 0, line
    assert len(kinds) == 4  # the public row, the products, the sums, and the copies (s0 and the sum's row)
    assert public == [witness["pub"]] and witness["pub"] == witness[f"s{(gates - 2) // 2 - 1}"]
    a = [witness[f"a{i}"] for i in range(100)]
    b = [(witness[f"b{i}"] + 128) % Q - 128 for i in range(100)]
    assert all(0 <= x < 256 for x in a) and all(-128 <= x < 128 for x in b) and min(b) < 0 <= max(b)
    assert witness["pub"] == sum(x * y for x, y in zip(a, b)) % Q


def test_the_family_imports_nothing_of_the_port_or_torch():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import plonkbench.circuits.inner_product; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'torch', 'numpy', 'jax', 'baby_plonk_tpu', 'baby_plonk_tpu_torch'}))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def _ip_root(tmp_path, gates: int = 16) -> str:
    """The small cell's copy, its configuration ``plonk16-innerprod-fb`` at ``gates`` rows."""
    root = small_root(tmp_path)
    config = json.load(open(CONFIG))
    config.update(name="small", circuit={"family": "inner_product", "gates": gates}, group_order=gates,
                  srs={"powers": gates + 6, "tau": "0xDEADBEEF"})
    with open(os.path.join(root, "plonkbench", "configs", "small.json"), "w") as f:
        json.dump(config, f)
    return root


def test_a_small_cell_of_the_configuration(tmp_path):
    """A traced run of 16 gates is correct and reports round 1's witness
    pass; a proof made without its blinding and a stale proof are not
    correct."""
    import torch

    from plonkbench.harness import Run, Session, is_correct, run_cell
    from plonkbench.spec import Cell

    torch.set_num_threads(1)
    root = _ip_root(tmp_path)
    out = io.StringIO()
    assert run_cell(root, "small-prove", 2**41 + 29, 0.1, True, device="cpu", out=out) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["metrics"]["round1_pack_ms"]["value"] > 0
    session = Session(Cell(root, "small-prove"), "cpu")
    verdicts = {}
    for i, fault in enumerate(("unblinded", "stale")):
        traffic = session.traffic(2**40 + 41 + i)
        serve = session.serve_fn(traffic, fault)
        session.warm(traffic, serve)
        records = session.window(traffic, serve, 0.1, Run())
        verdicts[fault] = is_correct(session.judge(traffic, records))
    assert verdicts == {"unblinded": False, "stale": False}

