"""Mean of the entry's timings["eri_s"] per job: the in-core V2 build
(kernel 1, the ket contraction and finish_terms). Absent in direct mode."""


def read(run):
    vals = [j.timings["eri_s"] for j in run.completed() if "eri_s" in j.timings]
    return sum(vals) / len(vals) if vals else None
