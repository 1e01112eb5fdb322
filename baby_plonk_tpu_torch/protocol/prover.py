"""The port's PLONK prover: ``baby_plonk_tpu.protocol.prover.Prover``
with ``TorchEngine`` as the default engine.

Only round 2 is overridden. The shared body checks the grand product's
closing value through ``baby_plonk_tpu.ops.msm``, which imports JAX; here
the same check compares the port's own closing tensor with 1 canonically.
"""
from __future__ import annotations

from baby_plonk_tpu.config import get_config
from baby_plonk_tpu.protocol import prover as _prover

from ..ops.limbs import FR
from ..ops.torch_engine import TorchEngine

K1, K2 = _prover.K1, _prover.K2


class Prover(_prover.Prover):
    def __init__(self, setup, program, engine=None):
        super().__init__(setup, program, engine=TorchEngine() if engine is None else engine)

    def round_2(self):
        gp_dev = getattr(self.engine, "grand_product_poly", None)
        if gp_dev is None:
            return super().round_2()
        z_poly, closing = gp_dev(
            self.a, self.b, self.c, self.pk, self.ch.beta, self.ch.gamma, K1, K2
        )
        if get_config().debug_asserts:
            # the full cycle returns to 1 (prover.rs:319)
            assert FR.unpack_mont(closing) == [1], "grand product does not close"
        b7, b8, b9 = self.blinding[6:9]
        self.z = z_poly
        self.z_coeff = self._blind_zh([b9, b8, b7]) + self._intt(self.z)
        return self._commit(self.z_coeff)
