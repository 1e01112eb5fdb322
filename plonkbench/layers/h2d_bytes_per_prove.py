"""h2d_bytes_per_prove: the port's ``h2d_bytes`` counter (utils/metrics.py,
counted at each copy of host data to the device, ``ops/limbs.py::
to_device``) over the traced window, per proof completed in it. Every field
element goes up as 16 int32 limbs, 64 bytes."""
from baby_plonk_tpu_torch.utils.metrics import get_metrics


def read(run):
    total = get_metrics().counters.get("h2d_bytes")
    return total / run.proofs if total and run.proofs else None
