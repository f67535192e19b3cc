"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated() over set-up and
window."""


def read(run):
    if run.peak_mem_bytes is None:
        return None
    return run.peak_mem_bytes / 2 ** 30
