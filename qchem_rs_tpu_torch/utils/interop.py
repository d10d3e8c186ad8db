"""Carry state from the JAX package's numpy arrays into the port.

Hartree-Fock has no weights: its state is the basis, the geometry and the
pair-group tensors (Hermite tables E, exponents p, centres P, Schwarz
bounds and sort orders). These functions take plain numpy arrays — as the
JAX package's objects hand them out through ``np.asarray`` — and build the
port's objects from them, so that both packages can be fed identical
inputs. Nothing here imports JAX.
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


def system_from_numpy(ordinals: np.ndarray, positions: np.ndarray, basis: BasisSet) -> MolecularSystem:
    """The port's system for atoms given as ordinals (natom,) and positions
    (natom, 3) in Bohr."""
    return MolecularSystem.from_arrays(np.asarray(ordinals), np.asarray(positions, dtype=np.float64), basis)


def pair_group_from_numpy(la: int, lb: int, i_shell, j_shell, ao_i, ao_j, E, p, P, device) -> PairGroup:
    """A port PairGroup from the fields of a JAX ``PairGroup`` as numpy
    arrays: E (n, Kab, A, S), p (n, Kab), P (n, Kab, 3)."""
    return PairGroup(
        la=int(la), lb=int(lb),
        i_shell=np.asarray(i_shell), j_shell=np.asarray(j_shell),
        ao_i=np.asarray(ao_i), ao_j=np.asarray(ao_j),
        p=to_tensor(p, device), P=to_tensor(P, device), E=to_tensor(E, device),
    )

