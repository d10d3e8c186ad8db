"""Closed-shell RHF with DIIS, on the reference's integrals, and the
checks that judge another program's converged result against it.

``Reference(mol, threshold, dtype)`` builds S, H = T + V and the operator
G[ij, kl] = (ij|kl) - 1/2 (ik|jl). ``solve()`` converges RHF from the
core-Hamiltonian guess: F = H + G(D), DIIS on the commutator FDS - SDF over
the last 8 iterations, the generalised eigenproblem through Löwdin's
S^-1/2, D = 2 C_occ C_occ^T, E = 1/2 Tr[D (H + F)] + E_nuc, until the
commutator's largest element is under 1e-10 and the energy moves by less
than 1e-12 Eh (1e-5 and 1e-6 in float32), in at most 200 iterations.
``judge`` takes another program's (E, orbital energies, D) at the same
geometry and returns its gaps to the reference: in energy, in orbital
energies, and the largest element of the commutator that the reference's
Fock matrix at that D leaves.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hfbench.reference.integrals import fock_operator, one_electron, pair_matrix
from hfbench.reference.molecule import Molecule

MAX_ITERATIONS = 200
DIIS_HISTORY = 8


@dataclasses.dataclass
class Solution:
    energy: float  # total, Eh
    orbital_energies: np.ndarray
    density: np.ndarray
    iterations: int
    converged: bool


class Reference:
    """RHF of ``mol`` in ``dtype`` (float64; float32 for the control)."""

    def __init__(self, mol: Molecule, threshold: float, dtype=torch.float64, device="cpu", charge: int = 0):
        self.mol, self.dtype, self.device = mol, dtype, torch.device(device)
        self.nocc = mol.n_occupied(charge)
        S, T, Vn = one_electron(mol, dtype, self.device)
        self.S, self.H = S, T + Vn
        self.G = fock_operator(pair_matrix(mol, threshold, dtype, self.device), mol.nao)
        w, U = torch.linalg.eigh(self.S)
        self.X = (U / torch.sqrt(w)) @ U.T
        self.e_nuc = mol.nuclear_repulsion()

    def fock(self, D: torch.Tensor) -> torch.Tensor:
        n = self.mol.nao
        return self.H + (self.G @ D.reshape(-1)).view(n, n)

    def _diagonalise(self, F):
        w, C = torch.linalg.eigh(self.X.T @ F @ self.X)
        C = self.X @ C
        Cocc = C[:, : self.nocc]
        return w, 2.0 * Cocc @ Cocc.T

    def solve(self) -> Solution:
        f64 = self.dtype == torch.float64
        commutator_stop, energy_stop = (1e-10, 1e-12) if f64 else (1e-5, 1e-6)
        _, D = self._diagonalise(self.H)
        Fs, errs, energy = [], [], 0.0
        for it in range(1, MAX_ITERATIONS + 1):
            F = self.fock(D)
            new_energy = float(0.5 * torch.sum(D * (self.H + F))) + self.e_nuc
            err = F @ D @ self.S - self.S @ D @ F
            worst = float(err.abs().max())
            if worst < commutator_stop and abs(new_energy - energy) < energy_stop:
                w, _ = self._diagonalise(F)
                return Solution(new_energy, w.cpu().double().numpy(), D.cpu().double().numpy(), it, True)
            energy = new_energy
            Fs, errs = (Fs + [F])[-DIIS_HISTORY:], (errs + [err])[-DIIS_HISTORY:]
            k = len(Fs)
            B = torch.zeros((k + 1, k + 1), dtype=torch.float64, device=self.device)
            E = torch.stack(errs).reshape(k, -1).double()
            B[:k, :k] = E @ E.T
            B[:k, k] = B[k, :k] = -1.0
            rhs = torch.zeros(k + 1, dtype=torch.float64, device=self.device)
            rhs[k] = -1.0
            c = torch.linalg.lstsq(B.cpu(), rhs.cpu()[:, None]).solution[:k, 0].to(self.device, self.dtype)
            _, D = self._diagonalise(torch.einsum("k,kij->ij", c, torch.stack(Fs)))
        F = self.fock(D)
        w, _ = self._diagonalise(F)
        energy = float(0.5 * torch.sum(D * (self.H + F))) + self.e_nuc
        return Solution(energy, w.cpu().double().numpy(), D.cpu().double().numpy(), MAX_ITERATIONS, False)

    def judge(self, reference: Solution, energy: float, orbital_energies, density) -> dict:
        """Gaps of another result at this geometry to ``reference``:
        energy_gap and orbital_gap (largest over all orbitals) in Eh, and
        commutator, max |F D S - S D F| with F the reference's Fock matrix
        at that density."""
        D = torch.as_tensor(np.asarray(density), dtype=self.dtype, device=self.device)
        F = self.fock(D)
        comm = F @ D @ self.S - self.S @ D @ F
        eps = np.asarray(orbital_energies, dtype=np.float64)
        return {
            "energy_gap": abs(float(energy) - reference.energy),
            "orbital_gap": float(np.abs(eps - reference.orbital_energies).max()),
            "commutator": float(comm.abs().max()),
        }
