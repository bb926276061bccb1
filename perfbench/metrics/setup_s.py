"""Set-up: from the process's start to the first timed call (imports, CUDA
and the kernel library, inputs, program state, one warm-up call an
input)."""


def read(run):
    return run.setup_s
