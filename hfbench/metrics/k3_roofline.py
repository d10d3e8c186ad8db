"""Kernel 3's share of its roofline over the traced jobs: the least time
of the direct passes' counted work (``counts.work.direct_pass`` per pass)
over the device time of kernel 3's kernels, in %."""

KERNELS = ("eri_tile_values",)


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.device_time(KERNELS)
    if device_s <= 0:
        return None
    least = sum((w["direct_pass"] * j.passes).least_s()
                for j, w in zip(run.traced, run.work["traced"]) if j.error is None)
    return 100.0 * least / device_s
