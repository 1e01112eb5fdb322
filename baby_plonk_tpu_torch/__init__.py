"""PyTorch + CUDA port of baby_plonk_tpu for one NVIDIA H100.

Imports ``torch``, never ``jax`` and nothing of ``baby_plonk_tpu``: the host
layer (config, fields, curves, circuits, protocol, the exact ``HostEngine``)
is the port's own copy under the same relative names, and everything that
touches a device is ``ops.torch_engine.TorchEngine`` with the hand-written
Hopper kernels under ``csrc/``.

    from baby_plonk_tpu_torch.protocol.setup import generate_srs_device
    from baby_plonk_tpu_torch.protocol.prover import Prover
    from baby_plonk_tpu_torch.ops.torch_engine import TorchEngine
"""
