"""The general generator of geometry streams: every traffic mix is a data
file of its parameters (``hfbench/traffic/<name>.json``), and the modes it
samples over are the configuration's (``modes``, made by
``derive_modes.py``).

Each job of a stream is the configuration's minimum x0 plus a classical
Boltzmann displacement over its harmonic modes at ``temperature_K``: every
mass-weighted normal coordinate q_k is Gaussian with variance kT / w_k^2,
and u = M^(-1/2) sum_k q_k L_k. Where ``rotate`` is true the geometry is
then turned about its centroid by a rotation drawn uniformly.

With ``pool`` P > 0 the displacements are not drawn anew for every job:
P of them are drawn once from ``pool_seed``, the same for every seed, and
a run's seed only orders them (a fresh permutation each time the pool is
used up) and draws each job's rotation. Every seed then measures the same
set of geometries' work in another order and orientation, as when one
fixed dataset of sampled geometries is recomputed.

A stream is fixed by (seed, role): the harness draws the warm-up jobs, the
measured jobs and the choice of jobs to check from separate roles, so one
seed gives the same inputs in every run.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

BOHR_PER_ANGSTROM = 1.0 / 0.529177210903
AMU_TO_ME = 1822.888486209
AU_TO_CM1 = 219474.6313632
KB_HARTREE_PER_K = 3.166811563e-6

WARMUP, WINDOW, CHECK = 1, 0, 2


def rng(seed: int, role: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, role]))


def rotation(g: np.random.Generator) -> np.ndarray:
    """A rotation matrix drawn uniformly (from a normalised Gaussian
    quaternion)."""
    w, x, y, z = (q := g.normal(size=4)) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def amplitudes(modes: dict, temperature_k: float) -> np.ndarray:
    """(3N, modes) Cartesian displacement (Bohr) per unit normal variate
    of each mode: M^(-1/2) L_k sqrt(kT) / w_k."""
    w = np.asarray(modes["frequencies_cm1"]) / AU_TO_CM1
    m = np.repeat(np.asarray(modes["masses_amu"]) * AMU_TO_ME, 3)
    kt = KB_HARTREE_PER_K * temperature_k
    return np.asarray(modes["modes"]) * (np.sqrt(kt) / w)[None, :] / np.sqrt(m)[:, None]


class GeometryStream:
    """Geometries (natom, 3) in Bohr, one per ``next`` call."""

    def __init__(self, params: dict, modes: dict, seed: int, role: int):
        self.x0 = np.asarray(modes["positions"], dtype=np.float64)
        self.amplitudes = amplitudes(modes, params["temperature_K"])
        self.rotate = bool(params.get("rotate", False))
        self.g = rng(seed, role)
        pool = int(params.get("pool", 0))
        g = np.random.default_rng(int(params.get("pool_seed", 0)))
        self.pool = [g.normal(size=self.amplitudes.shape[1]) for _ in range(pool)]
        self.order: list = []

    @classmethod
    def of(cls, params: dict, config: dict, root: Path, seed: int, role: int) -> "GeometryStream":
        """The stream of a cell: its mix's ``params`` about its
        configuration's ``modes`` file."""
        return cls(params, json.loads((root / config["modes"]).read_text()), seed, role)

    def _xi(self) -> np.ndarray:
        if not self.pool:
            return self.g.normal(size=self.amplitudes.shape[1])
        if not self.order:
            self.order = list(self.g.permutation(len(self.pool)))
        return self.pool[self.order.pop()]

    def next(self) -> np.ndarray:
        x = self.x0 + (self.amplitudes @ self._xi()).reshape(self.x0.shape)
        if self.rotate:
            c = x.mean(axis=0)
            x = (x - c) @ rotation(self.g).T + c
        return x
