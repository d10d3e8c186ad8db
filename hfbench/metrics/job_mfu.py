"""The whole job's share of the card's FP64 peak over the measured window:
the counted FLOPs of every completed job's Fock builds (in core: one V2
build and a matvec a pass; direct: a direct pass a pass) over the window's
wall time at 67 TFLOP/s, in %."""

from hfbench.counts.work import FP64_PEAK_FLOPS


def read(run):
    if not run.work:
        return None
    direct = run.config["fock_mode"] == "direct"
    flops = 0.0
    for j, w in zip(run.jobs, run.work["jobs"]):
        if j.error is None and j.converged:
            flops += j.passes * (w["direct_pass"].flops if direct else w["fock_matvec"].flops)
            flops += 0.0 if direct else w["v2_build"].flops
    return 100.0 * flops / (run.window_s * FP64_PEAK_FLOPS)
