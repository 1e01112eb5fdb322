"""The port runs without JAX and without the JAX package: a child
interpreter whose import system refuses ``jax`` and ``baby_plonk_tpu``
imports the port, builds its ``Setup`` from the port and re-proves the
frozen n = 8 fixture through its Prover, with TorchEngine("cpu") and with
MeshEngine over two CPU shards; and no source of the port, nor
``chip_smoke.py``, imports either."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import importlib.abc, json, os, sys

BLOCKED = ("jax", "jaxlib", "baby_plonk_tpu")

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name in BLOCKED or name.startswith(tuple(b + "." for b in BLOCKED)):
            raise ImportError(name + " is blocked in this interpreter")
        return None

sys.meta_path.insert(0, Blocker())
import torch
torch.set_num_threads(1)
import baby_plonk_tpu_torch
from baby_plonk_tpu_torch.ops.engine import HostEngine
from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
from baby_plonk_tpu_torch.parallel.mesh import make_mesh
from baby_plonk_tpu_torch.parallel.mesh_engine import MeshEngine
from baby_plonk_tpu_torch.protocol import Program, Proof, Prover, Setup, Verifier

fix = json.load(open(os.path.join(sys.argv[1], "tests", "fixtures", "golden_proof.json")))
setup = Setup.generate_srs(fix["group_order"] + 6, tau=fix["tau"], cache=False)
program = Program.from_strs(fix["circuit"], fix["group_order"])
proof = Prover(setup, program, engine=TorchEngine("cpu")).prove(fix["witness"], blinding=fix["blinding"])
assert proof.to_bytes().hex() == fix["proof_hex"], "proof bytes differ"
public = fix["public"]
assert Verifier(setup, program, Proof.from_bytes(proof.to_bytes()), engine=HostEngine()).verify(public)
mesh_proof = Prover(setup, program, engine=MeshEngine(make_mesh(2, device="cpu"))).prove(
    fix["witness"], blinding=fix["blinding"])
assert mesh_proof.to_bytes().hex() == fix["proof_hex"], "mesh proof bytes differ"
for b in BLOCKED:
    assert not any(m == b or m.startswith(b + ".") for m in sys.modules), b
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


#: an import of jax, jaxlib or the JAX package (``baby_plonk_tpu`` not
#: followed by ``_torch``), as a statement anywhere in a line
BAD_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|baby_plonk_tpu)(?![\w])|"
    r"^\s*import\s+.*[,\s](?:jax|jaxlib|baby_plonk_tpu)(?![\w])|"
    r"(?:__import__|import_module)\(\s*['\"](?:jax|jaxlib|baby_plonk_tpu)['\".]",
    re.M,
)


def _port_sources():
    pkg = os.path.join(ROOT, "baby_plonk_tpu_torch")
    for dirpath, dirs, files in os.walk(pkg):
        if "build" in dirs:  # the kernels' build output, not sources
            dirs.remove("build")
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_name_no_jax():
    found = []
    for path in _port_sources():
        with open(path) as f:
            found += [f"{path}: {m.group(0).strip()}" for m in BAD_IMPORT.finditer(f.read())]
    assert not found, found


def test_import_scan_catches_the_forms():
    for line in ("import jax", "from jax import numpy", "    from baby_plonk_tpu.fields import fr",
                 "import baby_plonk_tpu", "import os, jax", "from baby_plonk_tpu import config",
                 "importlib.import_module('baby_plonk_tpu.config')"):
        assert BAD_IMPORT.search(line), line
    for line in ("from baby_plonk_tpu_torch.fields import fr", "import baby_plonk_tpu_torch",
                 "# the JAX package: baby_plonk_tpu/ops/msm.py", "from ..fields import fr"):
        assert not BAD_IMPORT.search(line), line
