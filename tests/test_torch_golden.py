"""Both frozen golden fixtures re-prove through the port (TorchEngine on
the CPU, the kernels' plain versions) to the JAX package's frozen bytes."""
import json
import os

import pytest

from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

_DIR = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("name", ["golden_proof.json", "golden_proof_mul_chain.json"])
def test_golden_fixture_reproves(name):
    with open(os.path.join(_DIR, name)) as f:
        fix = json.load(f)
    setup = Setup.generate_srs(fix["group_order"] + 6, tau=fix["tau"], cache=False)
    program = Program.from_strs(fix["circuit"], fix["group_order"])
    prover = Prover(setup, program, engine=TorchEngine("cpu"))
    proof = prover.prove(fix["witness"], blinding=fix["blinding"])
    for ch, want in fix["challenges"].items():
        assert getattr(prover.ch, ch) == int(want, 16), ch
    assert proof.to_bytes().hex() == fix["proof_hex"]
