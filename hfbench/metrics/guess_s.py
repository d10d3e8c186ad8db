"""Mean of the entry's timings["guess_s"] (the SAD guess) per job."""


def read(run):
    vals = [j.timings["guess_s"] for j in run.completed() if "guess_s" in j.timings]
    return sum(vals) / len(vals) if vals else None
