"""Carry state from the JAX package's numpy arrays into the port.

Hartree-Fock has no weights: its state is the basis, the geometry and the
pair-group tensors (Hermite tables E, exponents p, centres P, Schwarz
bounds and sort orders), and an SCF's starting density. These functions
take plain numpy arrays — as the JAX package's objects hand them out
through ``np.asarray`` — and build the port's objects from them, so that
both packages can be fed identical inputs. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.eri import PairGroup
from qchem_rs_tpu_torch.utils.basis import BasisSet
from qchem_rs_tpu_torch.utils.system import MolecularSystem


def to_tensor(x, device) -> torch.Tensor:
    """A float64 tensor on ``device`` holding a copy of numpy ``x``."""
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


def system_from_numpy(ordinals: np.ndarray, positions: np.ndarray, basis: BasisSet,
                      spherical: bool = False) -> MolecularSystem:
    """The port's system for atoms given as ordinals (natom,) and positions
    (natom, 3) in Bohr, Cartesian or spherical as the JAX system's
    ``spherical`` flag says (its densities then live in the spherical
    basis, and ``density_guess`` carries them over as they are)."""
    return MolecularSystem.from_arrays(np.asarray(ordinals), np.asarray(positions, dtype=np.float64),
                                       basis, spherical=spherical)


def pair_group_from_numpy(la: int, lb: int, i_shell, j_shell, ao_i, ao_j, E, p, P, device) -> PairGroup:
    """A port PairGroup from the fields of a JAX ``PairGroup`` as numpy
    arrays: E (n, Kab, A, S), p (n, Kab), P (n, Kab, 3)."""
    return PairGroup(
        la=int(la), lb=int(lb),
        i_shell=np.asarray(i_shell), j_shell=np.asarray(j_shell),
        ao_i=np.asarray(ao_i), ao_j=np.asarray(ao_j),
        p=to_tensor(p, device), P=to_tensor(P, device), E=to_tensor(E, device),
    )



def density_guess(D, nao: int, nspin: int, device) -> torch.Tensor:
    """A starting density from numpy: (nao, nao) for RHF (``nspin`` 1) or
    the (2, nao, nao) spin stack for UHF (``nspin`` 2), as the JAX package's
    entry points take it, as a float64 tensor on ``device``; ``nao`` is the
    size of the working basis (spherical for a spherical system)."""
    shape = (nao, nao) if nspin == 1 else (nspin, nao, nao)
    D = np.asarray(D, dtype=np.float64)
    if D.shape != shape:
        raise ValueError(f"density guess has shape {D.shape}, expected {shape}")
    return to_tensor(D, device)
