"""Wall seconds of the measured window over the converged jobs it completed."""


def read(run):
    done = len(run.completed())
    return run.window_s / done if done else None
