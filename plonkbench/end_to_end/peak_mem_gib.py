"""peak_mem_gib: torch.cuda.max_memory_allocated from the process's start
to the window's end, cold prove included, in GiB. It decides the largest
circuit a card proves, and guards the port's memory governors."""


def read(run):
    return run.peak_mem_bytes / 2**30 if run.peak_mem_bytes else None
