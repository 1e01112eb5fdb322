"""setup_s: seconds from the process's start to the first timed request:
the library, the SRS, the program and proving key, the witness pool, the
NTT plans and one cold prove (host clock)."""


def read(run):
    return run.setup_s
