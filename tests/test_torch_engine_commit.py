"""The port's three commit configurations at n = 8 on the CPU: with fixed
blinding, ``TorchEngine("cpu")`` gives the same proof bytes under the
fixed-base tables, the bit-serial variable-base MSM and the sorted-bucket
Pippenger MSM, equal to the port's exact ``HostEngine``. Tolerance: exact
(bytes)."""
import pytest

from baby_plonk_tpu_torch import config
from baby_plonk_tpu_torch.ops import msm, msm_fixed
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Prover, Setup, Verifier

from torch_port_util import one_torch_thread  # noqa: F401  (fixture)

CIRCUIT = ["e public", "c <== a * b + b", "e <== c * d"]
WITNESS = {"a": 3, "b": 4, "c": 16, "d": 5, "e": 80}
BLINDING = list(range(1, 12))


@pytest.fixture(scope="module")
def host_proof():
    setup = Setup.generate_srs(8 + 6, tau=101, cache=False)
    program = Program.from_strs(CIRCUIT, 8)
    proof = Prover(setup, program, engine=HostEngine()).prove(WITNESS, blinding=BLINDING)
    return setup, program, proof.to_bytes()


@pytest.fixture
def use_config():
    prev = config.get_config()

    def install(**kw):
        config.set_config(config.Config(**kw))

    yield install
    config.set_config(prev)


@pytest.mark.parametrize(
    "fixed_base, algorithm",
    [(True, "bitserial"), (False, "bitserial"), (False, "pippenger")],
    ids=["fixed", "bitserial", "pippenger"],
)
def test_commit_configs_same_proof_bytes(host_proof, use_config, monkeypatch, fixed_base, algorithm):
    setup, program, want = host_proof
    use_config(commit_fixed_base=fixed_base, msm_algorithm=algorithm)
    variable, horner = [], []
    real_msm, real_tables = msm.msm_device_arrays, msm_fixed.FixedBaseTables.msm_many
    monkeypatch.setattr(msm, "msm_device_arrays",
                        lambda *a: variable.append(1) or real_msm(*a))
    monkeypatch.setattr(msm_fixed.FixedBaseTables, "msm_many",
                        lambda self, s: horner.append(1) or real_tables(self, s))
    engine = TorchEngine("cpu")
    proof = Prover(setup, program, engine=engine).prove(WITNESS, blinding=BLINDING)
    assert proof.to_bytes() == want
    # the configuration chose the path: 9 commits in 4 rounds
    assert (len(variable), len(horner)) == ((0, 4) if fixed_base else (9, 0))
    assert Verifier(setup, program, proof, engine=HostEngine()).verify([80])


def test_unknown_algorithm_raises(host_proof, use_config):
    setup, program, _ = host_proof
    use_config(commit_fixed_base=False, msm_algorithm="windowed")
    with pytest.raises(ValueError):
        Prover(setup, program, engine=TorchEngine("cpu")).prove(WITNESS, blinding=BLINDING)
