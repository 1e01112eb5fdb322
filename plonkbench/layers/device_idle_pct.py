"""device_idle_pct: the share of the traced window in which no kernel, copy
or set runs on the card, from the union of the trace's device intervals."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 and t.busy_s > 0 else None
