"""The exact host oracles the port is checked against, re-exported so that
a check of the port (``chip_smoke.py``) imports nothing of the JAX package
itself: ``HostEngine`` (Python-int NTT, grand product and MSM behind the
engine contract) and ``msm_host.msm``. Both are JAX-free host code; the
port's own path never calls them.
"""
from baby_plonk_tpu.curves import msm_host
from baby_plonk_tpu.ops.engine import HostEngine

__all__ = ["HostEngine", "msm_host"]
