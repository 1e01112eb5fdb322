"""round1_pack_ms: the port's ``dpoly.from_ints`` spans with
``prover.round_1`` among their ancestors (the reduction, limb packing,
upload and ``to_mont`` of round 1's columns and blinding polynomials;
``ops/dpoly.py``) over the traced window, per proof completed in it, from
the records of the port's recorder."""
from baby_plonk_tpu_torch.utils.metrics import get_metrics

SPAN, ROUND = "dpoly.from_ints", "prover.round_1"


def _in_round(records, r) -> bool:
    while r.parent is not None:
        r = records[r.parent]
        if r.name == ROUND:
            return True
    return False


def read(run):
    records = getattr(get_metrics(), "records", [])
    total = sum(r.end - r.start for r in records if r.name == SPAN and _in_round(records, r))
    return total / run.proofs * 1e3 if total and run.proofs else None
