"""Molecular properties from a converged SCF density (port of
``qchem_rs_tpu/models/properties.py``): the electric dipole moment and
Mulliken charges, and UHF's <S^2> (``models/uhf.py``'s
``spin_expectation``, re-exported here). Each takes numpy densities, as
the SCF outputs hold them, computes its integrals on ``device`` (the card
by default; raises without CUDA, as the SCF entry points do) and returns
numpy values.
"""

from __future__ import annotations

import numpy as np
import torch

from qchem_rs_tpu_torch.models.rhf import check_device
from qchem_rs_tpu_torch.models.uhf import spin_expectation
from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.utils.system import MolecularSystem

__all__ = ["AU_TO_DEBYE", "dipole_moment", "mulliken_charges", "spin_expectation"]

#: 1 atomic unit of electric dipole in Debye
AU_TO_DEBYE = 2.541746473


def dipole_moment(system: MolecularSystem, density: np.ndarray, device="cuda") -> np.ndarray:
    """Electric dipole (a.u.), origin at 0: mu = sum_A Z_A R_A - Tr[D r].

    ``density`` is the total density in the working basis: RHF's
    ``output.density``, or the spin sum ``D[0] + D[1]`` for UHF. Independent
    of the origin for a neutral molecule."""
    device = check_device(device)
    D = torch.as_tensor(np.asarray(density), dtype=torch.float64, device=device)
    mu_e = torch.einsum("dij,ij->d", one_electron.dipole_integrals(system, device), D)
    mu_n = (np.asarray(system.charges, dtype=float)[:, None] * np.asarray(system.positions)).sum(0)
    return mu_n - mu_e.cpu().numpy()


def mulliken_charges(system: MolecularSystem, density: np.ndarray, device="cuda") -> np.ndarray:
    """Mulliken atomic partial charges: q_A = Z_A - sum over i on A of (D S)_ii."""
    device = check_device(device)
    D = torch.as_tensor(np.asarray(density), dtype=torch.float64, device=device)
    S = one_electron.overlap(system, device)
    pops = torch.diagonal(D @ S).cpu().numpy()
    q = np.asarray(system.charges, dtype=float).copy()
    np.subtract.at(q, system.ao_atom_indices(), pops)
    return q
