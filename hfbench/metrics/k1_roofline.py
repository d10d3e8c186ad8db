"""Kernel 1's share of its roofline over the traced jobs: the least time
of each job's V2 build (``counts.work.v2_build``) over the device time of
kernel 1's kernels, in %."""

KERNELS = ("eri_bra_tiles", "highl_zero_kernel", "highl_reduce_kernel")


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_time(KERNELS)
    if device_s <= 0:
        return None
    least = sum(w["v2_build"].least_s() for j, w in zip(run.traced, run.work["traced"]) if j.error is None)
    return 100.0 * least / device_s
