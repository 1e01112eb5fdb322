"""pippenger_roofline: the least time an H100 could take for the window's
variable-base Pippenger MSMs, over the device time the trace gives their
kernels (``plonkbench/work/pippenger.py::KERNELS``, csrc/pippenger.cu), in %.

The least time is counted for each of the port's ``msm.pippenger`` spans
from its ``size`` (the points) alone, with the frozen work count of
``plonkbench/work/pippenger.py`` (digits saturated: above the real digits'
count by about 0.23%). None where the spans carry no size or the trace
holds none of the kernels (a CPU run). The sort of the digits (torch's own
kernels) is outside both.
"""
from baby_plonk_tpu_torch.utils.metrics import get_metrics
from plonkbench.work import pippenger

SPAN = "msm.pippenger"


def read(run):
    t = run.trace
    sizes = [getattr(r, "size", None) for r in getattr(get_metrics(), "records", ()) if r.name == SPAN]
    if not t or not sizes or None in sizes:
        return None
    busy = sum(t.by_name[k][1] for k in pippenger.KERNELS if k in t.by_name)
    return 100.0 * sum(map(pippenger.pippenger_bound_s, sizes)) / busy if busy else None
