"""95th percentile of the window's job wall times (harness clock), by
linear interpolation between order statistics."""

import numpy as np


def read(run):
    walls = [j.wall_s for j in run.jobs]
    return float(np.percentile(walls, 95)) if walls else None
