"""Protocol entry points of the port.

The circuit front end, transcript, proof format and verifier are the
shared, JAX-free host modules of ``baby_plonk_tpu`` (re-exported here);
the device SRS and the prover are the port's own.
"""
from baby_plonk_tpu.circuits import mul_chain
from baby_plonk_tpu.protocol.program import Program
from baby_plonk_tpu.protocol.proof import Proof
from baby_plonk_tpu.protocol.setup import Setup
from baby_plonk_tpu.protocol.verifier import Verifier

__all__ = ["Program", "Proof", "Setup", "Verifier", "mul_chain"]
