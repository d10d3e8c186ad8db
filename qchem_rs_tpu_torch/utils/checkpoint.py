"""SCF checkpoint and resume (port of ``qchem_rs_tpu/utils/checkpoint.py``).

A converged (or intermediate) SCF state is written to an ``.npz`` file
under the same keys as the JAX package's, so a checkpoint written by
either package loads in the other; its density warm-starts a later run
through the entry points' ``density_guess``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class ScfCheckpoint:
    kind: str  # "rhf" | "uhf"
    density: np.ndarray  # (n, n) or (2, n, n)
    coefficients: np.ndarray
    orbital_energies: np.ndarray
    electronic_energy: float
    iterations: int
    positions: np.ndarray
    basis_name: str

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path,
            kind=self.kind,
            density=self.density,
            coefficients=self.coefficients,
            orbital_energies=self.orbital_energies,
            electronic_energy=self.electronic_energy,
            iterations=self.iterations,
            positions=self.positions,
            basis_name=self.basis_name,
        )

    @classmethod
    def load(cls, path: str | Path) -> "ScfCheckpoint":
        with np.load(path, allow_pickle=False) as z:
            return cls(
                kind=str(z["kind"]),
                density=z["density"],
                coefficients=z["coefficients"],
                orbital_energies=z["orbital_energies"],
                electronic_energy=float(z["electronic_energy"]),
                iterations=int(z["iterations"]),
                positions=z["positions"],
                basis_name=str(z["basis_name"]),
            )


def from_rhf_output(out, system) -> ScfCheckpoint:
    return ScfCheckpoint(
        kind="rhf",
        density=out.density,
        coefficients=out.coefficients,
        orbital_energies=out.orbital_energies,
        electronic_energy=out.electronic_energy,
        iterations=out.iterations,
        positions=np.asarray(system.positions),
        basis_name=system.basis.name,
    )


def from_uhf_output(out, system) -> ScfCheckpoint:
    return ScfCheckpoint(
        kind="uhf",
        density=out.density,
        coefficients=out.coefficients,
        orbital_energies=np.stack([out.orbital_energies_alpha, out.orbital_energies_beta]),
        electronic_energy=out.electronic_energy,
        iterations=out.iterations,
        positions=np.asarray(system.positions),
        basis_name=system.basis.name,
    )
