"""transcript_ms: the port's ``prover.transcript`` spans (the five rounds'
Fiat-Shamir challenges, STROBE over Keccak in host Python, and the points'
compression; ``protocol/prover.py``) over the traced window, per proof
completed in it, from the records of the port's recorder."""
from baby_plonk_tpu_torch.utils.metrics import get_metrics

SPAN = "prover.transcript"


def read(run):
    total = sum(r.end - r.start for r in getattr(get_metrics(), "records", ()) if r.name == SPAN)
    return total / run.proofs * 1e3 if total and run.proofs else None
