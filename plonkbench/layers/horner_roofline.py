"""horner_roofline: the least time an H100 could take for the Horner
launches of the window's commits (``msm_fixed_kernel``, csrc/msm_fixed.cu),
over the device time the trace gives that kernel, in %.

The least time is counted from each commit's shapes (scalar sets, longest
scalar array, chunk), with the frozen work formula and peaks of
``plonkbench/work/roofline.py``: of the fixed-base method with 8-point
tables as it stands. Every table index is counted nonzero, an overcount of
the additions by about 1/256. A change of the method is for a change of
the benchmark to count.
"""
from plonkbench.work import roofline

KERNEL = "msm_fixed_kernel"


def read(run):
    t = run.trace
    if not t or KERNEL not in t.by_name or not t.commits:
        return None
    least = sum(roofline.bound_s(*roofline.horner_work(P, k, chunk, run.sms)) for P, k, chunk in t.commits)
    return 100.0 * least / t.by_name[KERNEL][1]
