"""Mean SCF passes per job (iterations + 1)."""


def read(run):
    done = run.completed()
    return sum(j.passes for j in done) / len(done) if done else None
