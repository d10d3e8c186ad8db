"""Mean of scf_s / passes per job, in ms: one SCF pass with its Fock build
(kernel 2 in core, the direct pass in direct mode), DIIS and eigensolve."""


def read(run):
    vals = [1e3 * j.timings["scf_s"] / j.passes for j in run.completed()]
    return sum(vals) / len(vals) if vals else None
