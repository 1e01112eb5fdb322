"""KZG setup on the device for the port (counterpart of
``baby_plonk_tpu/protocol/setup.py::Setup.generate_srs_device``, :46-99).

Returns the shared host ``Setup`` type: its G1 powers live on the device
in ``Setup._torch_points`` (keyed by device), ``x_2`` = tau G2 on the
host, ``powers_of_x`` stays None. No disk cache.
"""
from __future__ import annotations

import torch

from baby_plonk_tpu.curves.g2 import G2
from baby_plonk_tpu.fields import fr
from baby_plonk_tpu.protocol.setup import Setup

from ..ops import srs


def generate_srs_device(powers: int, tau: int, device="cuda") -> Setup:
    """SRS [tau^i G1]_{i < powers} computed on ``device`` by the
    powers-of-tau kernel, plus tau G2 on the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("generate_srs_device: no CUDA device is available")
    tau %= fr.Q
    setup = Setup(None, G2.generator() * tau, n_powers=powers)
    setup._torch_points = {str(device): srs.powers_of_tau_device(powers, tau, device)}
    return setup
