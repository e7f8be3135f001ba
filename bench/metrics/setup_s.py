"""setup_s: seconds from the process's start to the window's: imports,
inputs, the operator build or the engine's fill, warm-up, and in a
checkout's first run the kernels' build."""


def read(run):
    return run.setup_s
