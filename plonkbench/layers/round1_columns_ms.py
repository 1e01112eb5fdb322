"""round1_columns_ms: the port's ``prover.columns`` spans (round 1's three
wire columns as Python ints, ``protocol/prover.py``) over the traced
window, per proof completed in it, from the records that the port's
recorder keeps while the profiler runs."""
from baby_plonk_tpu_torch.utils.metrics import get_metrics

SPAN = "prover.columns"


def read(run):
    total = sum(r.end - r.start for r in getattr(get_metrics(), "records", ()) if r.name == SPAN)
    return total / run.proofs * 1e3 if total and run.proofs else None
