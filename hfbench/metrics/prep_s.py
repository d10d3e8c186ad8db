"""Mean host preparation per job: the entry's total_s less its eri_s (the
in-core V2 build; absent in direct mode) and scf_s: one-electron integrals,
pair groups, Schwarz bounds, tile lists and the direct pass's plan."""


def read(run):
    vals = [j.timings["total_s"] - j.timings.get("eri_s", 0.0) - j.timings["scf_s"] for j in run.completed()]
    return sum(vals) / len(vals) if vals else None
