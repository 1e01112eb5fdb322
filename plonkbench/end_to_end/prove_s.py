"""prove_s: seconds of the whole measured window over the proofs completed
in it (host clock; the window runs from the first request's start to the
last proof's bytes on the host). What a proving service pays per proof."""


def read(run):
    return run.window_s / run.proofs if run.proofs else None
