"""End to end: seconds from the process's start to the first timed
request (imports, CUDA context, lowering, the program's set-up, the
kernels' build or load, the mix's warm-up requests)."""


def read(run):
    return run.setup_s
