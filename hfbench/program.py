"""The system under test, ``qchem_rs_tpu_torch``: its RHF entry point at
each geometry of a stream, and nothing else of it. This module is the only
one of the benchmark that imports the port."""

from __future__ import annotations

from pathlib import Path

import numpy as np


class Program:
    """``restricted_hartree_fock`` of the configured molecule, basis and
    settings, at any geometry."""

    def __init__(self, config: dict, root: Path, device: str):
        from qchem_rs_tpu_torch.config import HartreeFockConfig
        from qchem_rs_tpu_torch.utils.basis import BasisSet
        from qchem_rs_tpu_torch.utils.system import MolecularSystem

        self.system = MolecularSystem.load(root / config["molecule"], BasisSet.load(root / config["basis"]),
                                           spherical=config["spherical"])
        self.settings = HartreeFockConfig(
            max_iterations=config["max_iterations"], epsilon=config["epsilon"],
            convergence_metric=config["convergence_metric"], charge=config["charge"],
            screening_threshold=config["screening_threshold"], fock_mode=config["fock_mode"],
            initial_guess=config["initial_guess"])
        self.device = device

    def run(self, positions: np.ndarray):
        """The entry's ``RestrictedHartreeFockOutput`` at ``positions`` (Bohr)."""
        from qchem_rs_tpu_torch.models.rhf import restricted_hartree_fock

        return restricted_hartree_fock(self.system.with_positions(positions), self.settings, device=self.device)
