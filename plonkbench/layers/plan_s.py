"""plan_s: the NTT plans, paid once a process: for each transform size the
prove uses (n and 4n) and each direction, the first transform's time less
the second's, made by the harness in set-up before the cold prove (as the
port's ``bench.py`` does)."""


def read(run):
    return run.setup_parts.get("plan_s")
