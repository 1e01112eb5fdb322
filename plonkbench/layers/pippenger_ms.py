"""pippenger_ms: the device time the trace gives the variable-base
Pippenger MSM's kernels (``plonkbench/work/pippenger.py::KERNELS``,
csrc/pippenger.cu: repack, the chunk walk and its joins, segments, window
trees, Horner) over the traced window, per proof completed in it. The sort
of the digits and the host's part of each call are outside it, so it tells
a change in the kernels from one in the work around them. None where the
trace holds none of them."""
from plonkbench.work import pippenger


def read(run):
    t = run.trace
    total = sum(t.by_name[k][1] for k in pippenger.KERNELS if k in t.by_name) if t else 0
    return total / run.proofs * 1e3 if total and run.proofs else None
