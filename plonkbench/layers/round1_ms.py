"""round1_ms: the port's ``prover.round_1`` span (utils/metrics.py), summed
over the traced window, per proof completed in it. Round 1 is host Python:
the wire columns as Python ints, their packing, the blinding, the three
commits."""


def read(run):
    total = run.spans.get("prover.round_1")
    return total / run.proofs * 1e3 if total and run.proofs else None
