"""setup_s: seconds from the process's start to the window's: imports, the
kernels' build or load, weights and inputs, and the warm-up that captures
or compiles everything the window runs, host clock."""


def read(run):
    return run.setup_s
