"""prove_p90_s: the 90th percentile of the latencies of every request in
the window, from its start to its proof's bytes on the host (host clock).
It needs at least 5 requests above the percentile, so 50 in the window (at
51 s, up to 1.02 s a proof: 1.7 times the slowest window seen, 0.59 s on
a slow host); a window with fewer is an error of the cell, not a
reading."""
import statistics

LEAST = 50


def read(run):
    lat = run.latencies
    if len(lat) < LEAST:
        raise ValueError(f"prove_p90_s needs {LEAST} proofs in the window; it holds {len(lat)}")
    return statistics.quantiles(lat, n=10, method="inclusive")[-1]
