"""PyTorch + CUDA port of baby_plonk_tpu for one NVIDIA H100.

Imports ``torch`` and never ``jax``. The protocol layer (program, prover,
verifier, transcript, host fields and curves) is shared, read-only, with
the JAX-free modules of ``baby_plonk_tpu``; everything that touches a
device is this package's own: ``ops.torch_engine.TorchEngine`` and the
hand-written Hopper kernels under ``csrc/``.

    from baby_plonk_tpu_torch.protocol.setup import generate_srs_device
    from baby_plonk_tpu_torch.protocol.prover import Prover
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
"""
