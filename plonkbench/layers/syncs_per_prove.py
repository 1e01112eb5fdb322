"""syncs_per_prove: the port's ``host_syncs`` counter (utils/metrics.py)
over the traced window, per proof completed in it: each read of device data
(``ops/limbs.py::to_host``) and each blocking copy up from pageable memory
(``to_device``), which waits for every launch before it."""
from baby_plonk_tpu_torch.utils.metrics import get_metrics


def read(run):
    total = get_metrics().counters.get("host_syncs")
    return total / run.proofs if total and run.proofs else None
