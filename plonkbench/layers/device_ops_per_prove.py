"""device_ops_per_prove: kernel, copy and set records in the profiler's
CUDA trace over the traced window, per proof completed in it. It counts
torch's own copy and fill kernels too, which the port's launch counters
miss."""


def read(run):
    return run.trace.device_ops / run.proofs if run.trace and run.proofs else None
