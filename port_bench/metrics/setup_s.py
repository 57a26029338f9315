"""End to end: process start to the window's start (interpreter and
torch import, the CUDA context, builds, traffic generation, warm-up)."""


def read(run):
    return run["setup_s"]
