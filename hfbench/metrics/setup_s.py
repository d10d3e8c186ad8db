"""Process start to the first measured job: imports, CUDA context, the
kernels' load (or build), the SAD cache and one warm-up job."""


def read(run):
    return run.setup_s
