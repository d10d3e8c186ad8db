"""What a run keeps of its jobs, and what the metric readers read."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Job:
    """One call of the entry: its input, the harness clock around it and
    what it returned (or the error it raised)."""

    positions: np.ndarray
    wall_s: float
    energy: float | None = None
    orbital_energies: np.ndarray | None = None
    density: np.ndarray | None = None
    converged: bool = False
    passes: int = 0
    timings: dict = dataclasses.field(default_factory=dict)
    error: str | None = None


@dataclasses.dataclass
class Run:
    """Everything a reader may take a metric from.

    ``jobs`` are the measured window's, ``traced`` the jobs run under the
    profiler after it (``--trace 1`` only), ``trace`` their
    ``trace.Summary``, and ``work`` the counted work (``counts.work.Work``
    per kind, a dict per job) of ``jobs`` and ``traced`` (``--trace 1``
    only)."""

    cell: dict
    config: dict
    setup_s: float
    window_s: float
    jobs: list
    peak_bytes: int
    traced: list = dataclasses.field(default_factory=list)
    trace: object = None
    work: dict = dataclasses.field(default_factory=dict)

    def completed(self) -> list:
        return [j for j in self.jobs if j.error is None and j.converged]
