"""End to end: ``torch.cuda.max_memory_allocated`` over the window."""


def read(run):
    if run["peak_bytes"] is None:
        return None
    return run["peak_bytes"] / 2 ** 30
