"""Share of the traced jobs' untraced wall in which no kernel, memcpy or
memset ran on the card, in %: the busy time from a device-only trace of
three jobs, over the host-clock wall of the same three geometries run just
before without the profiler (the profiler's cost on the host would
lengthen the traced window and read as idle time)."""


def read(run):
    if run.trace is None or not run.trace.untraced_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.untraced_s)
