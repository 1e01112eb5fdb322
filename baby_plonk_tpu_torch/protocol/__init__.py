"""Protocol layer of the port: circuit front end, transcript, proof format,
setup, prover and verifier (host code of the port's own; the device work
goes through ``ops.torch_engine.TorchEngine``).
"""
from ..circuits import mul_chain
from .program import Program
from .proof import Proof
from .prover import Prover
from .setup import Setup
from .verifier import Verifier

__all__ = ["Program", "Proof", "Prover", "Setup", "Verifier", "mul_chain"]
