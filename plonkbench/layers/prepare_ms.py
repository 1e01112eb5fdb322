"""prepare_ms: the port's ``prover.prepare`` spans (the reduction of the
witness and the blinding, and the public-input column with its packing,
before round 1; ``protocol/prover.py``) over the traced window, per proof
completed in it, from the records of the port's recorder."""
from baby_plonk_tpu_torch.utils.metrics import get_metrics

SPAN = "prover.prepare"


def read(run):
    total = sum(r.end - r.start for r in getattr(get_metrics(), "records", ()) if r.name == SPAN)
    return total / run.proofs * 1e3 if total and run.proofs else None
