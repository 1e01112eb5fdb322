"""The port runs without JAX: a child interpreter whose import system
refuses ``jax`` imports the port and re-proves the frozen n = 8 fixture
through its Prover and TorchEngine("cpu"); and no module of the port names
jax or a JAX-importing module of the JAX package."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import importlib.abc, json, os, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this interpreter")
        return None

sys.meta_path.insert(0, NoJax())
import torch
torch.set_num_threads(1)
import baby_plonk_tpu_torch
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.protocol import Program, Setup
from baby_plonk_tpu_torch.protocol.prover import Prover

fix = json.load(open(os.path.join(sys.argv[1], "tests", "fixtures", "golden_proof.json")))
setup = Setup.generate_srs(fix["group_order"] + 6, tau=fix["tau"], cache=False)
program = Program.from_strs(fix["circuit"], fix["group_order"])
proof = Prover(setup, program, engine=TorchEngine("cpu")).prove(fix["witness"], blinding=fix["blinding"])
assert proof.to_bytes().hex() == fix["proof_hex"], "proof bytes differ"
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("NOJAX-OK")
'''


def test_port_proves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-c", CHILD, ROOT], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NOJAX-OK" in res.stdout


#: modules of the JAX package that import JAX when loaded
JAX_MODULES = (
    "limbs", "ntt", "g1_vec", "msm", "msm_fixed", "msm_pippenger", "srs", "dpoly",
    "prover_kernels", "tpu_engine", "pallas_kernels",
)


def test_port_sources_name_no_jax():
    pkg = os.path.join(ROOT, "baby_plonk_tpu_torch")
    bad = re.compile(
        r"^\s*(import jax|from jax|import jaxlib|from jaxlib"
        r"|from baby_plonk_tpu\.ops import .*\b(" + "|".join(JAX_MODULES) + r")\b"
        r"|from baby_plonk_tpu\.ops\.(" + "|".join(JAX_MODULES) + r")\b"
        r"|import baby_plonk_tpu\.ops\.(" + "|".join(JAX_MODULES) + r")\b)",
        re.M,
    )
    found = []
    for dirpath, dirs, files in os.walk(pkg):
        if "build" in dirs:  # the kernels' build output, not sources
            dirs.remove("build")
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                found += [f"{path}: {m.group(0).strip()}" for m in bad.finditer(open(path).read())]
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    found += [f"chip_smoke.py: {line}" for line in smoke.splitlines()
              if re.match(r"\s*(import|from) (jax|baby_plonk_tpu)\b(?!_torch)", line)]
    assert not found, found
