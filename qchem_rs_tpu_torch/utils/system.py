"""Molecular system: atoms + contracted-Gaussian shells grouped into
static-shape classes (copy of ``qchem_rs_tpu/utils/system.py``).

Molecule JSON format matches ``data/mol/*.json``: a list of
``{"element": "<ordinal-as-string>", "position": [x, y, z]}`` with positions
in Bohr. Shells are grouped into **classes by angular momentum l**, each
class a set of flat arrays padded to the class's max contraction degree, so
every integral class (la, lb[, lc, ld]) is one batched tensor computation.
numpy only; the spherical (5d/7f) transform is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from qchem_rs_tpu_torch.ops.angular import component_norms, double_factorial, ncart
from qchem_rs_tpu_torch.utils.basis import BasisSet


@dataclasses.dataclass(frozen=True)
class Atom:
    """An atom: nuclear charge (ordinal) and position in Bohr."""

    ordinal: int
    position: np.ndarray  # (3,)


@dataclasses.dataclass(frozen=True)
class Shell:
    """One contracted shell placed on an atom (host-side bookkeeping)."""

    index: int  # global shell index
    l: int
    atom_index: int
    center: np.ndarray  # (3,)
    exponents: np.ndarray  # (K,)
    coefficients: np.ndarray  # (K,) — normalized (see _normalize_coefficients)
    ao_offset: int  # first AO index of this shell


@dataclasses.dataclass(frozen=True)
class ShellClass:
    """All shells of one angular momentum, padded to a common contraction
    degree K. Padded primitives have coefficient 0 (and exponent 1 so no
    NaNs/Infs appear in intermediate math)."""

    l: int
    shell_indices: np.ndarray  # (ns,) global shell index
    centers: np.ndarray  # (ns, 3)
    alphas: np.ndarray  # (ns, K)
    coefs: np.ndarray  # (ns, K)
    ao_offsets: np.ndarray  # (ns,)
    atom_indices: np.ndarray  # (ns,)

    @property
    def nshells(self) -> int:
        return len(self.ao_offsets)

    @property
    def K(self) -> int:
        return self.alphas.shape[1]


def _primitive_norm(alpha: np.ndarray, l: int) -> np.ndarray:
    """Norm of the (l,0,0) Cartesian primitive x^l exp(-a r^2)."""
    dfl = double_factorial(2 * l - 1)
    return (2.0 * alpha / np.pi) ** 0.75 * (4.0 * alpha) ** (l / 2.0) / np.sqrt(dfl)


def _normalize_coefficients(alpha: np.ndarray, coef: np.ndarray, l: int) -> np.ndarray:
    """BSE coefficients refer to normalized primitives; fold primitive norms
    in, then renormalize the contraction so the (l,0,0) component has unit
    self-overlap. Per-Cartesian-component factors are applied separately via
    ``component_norms``."""
    c = coef * _primitive_norm(alpha, l)
    ap = alpha[:, None] + alpha[None, :]
    dfl = double_factorial(2 * l - 1)
    # <(l00)_p | (l00)_q> on the same center
    s_pq = (np.pi / ap) ** 1.5 * dfl / (2.0 * ap) ** l
    self_overlap = c @ s_pq @ c
    return c / np.sqrt(self_overlap)


class MolecularSystem:
    """Atoms + basis expanded into shells and shell classes (Cartesian AOs)."""

    def __init__(self, atoms: list[Atom], basis: BasisSet, spherical: bool = False):
        if spherical:
            raise NotImplementedError("spherical AOs are not ported yet")
        self.atoms = atoms
        self.basis = basis
        self.spherical = False

        shells: list[Shell] = []
        ao = 0
        for ai, atom in enumerate(atoms):
            for spec in basis.shells_for(atom.ordinal):
                coefs = _normalize_coefficients(spec.exponents, spec.coefficients, spec.l)
                shells.append(
                    Shell(
                        index=len(shells),
                        l=spec.l,
                        atom_index=ai,
                        center=np.asarray(atom.position, dtype=np.float64),
                        exponents=spec.exponents,
                        coefficients=coefs,
                        ao_offset=ao,
                    )
                )
                ao += ncart(spec.l)
        self.shells = shells
        self._n_basis = ao

        # group into static-shape classes by l
        self.shell_classes: dict[int, ShellClass] = {}
        for l in sorted({s.l for s in shells}):
            group = [s for s in shells if s.l == l]
            K = max(len(s.exponents) for s in group)
            ns = len(group)
            alphas = np.ones((ns, K), dtype=np.float64)
            coefs = np.zeros((ns, K), dtype=np.float64)
            centers = np.zeros((ns, 3), dtype=np.float64)
            offs = np.zeros(ns, dtype=np.int64)
            atom_idx = np.zeros(ns, dtype=np.int64)
            sidx = np.zeros(ns, dtype=np.int64)
            for i, s in enumerate(group):
                k = len(s.exponents)
                alphas[i, :k] = s.exponents
                coefs[i, :k] = s.coefficients
                centers[i] = s.center
                offs[i] = s.ao_offset
                atom_idx[i] = s.atom_index
                sidx[i] = s.index
            self.shell_classes[l] = ShellClass(
                l=l,
                shell_indices=sidx,
                centers=centers,
                alphas=alphas,
                coefs=coefs,
                ao_offsets=offs,
                atom_indices=atom_idx,
            )

        # per-AO Cartesian component renormalization (see ops/angular.py)
        norms = np.zeros(ao, dtype=np.float64)
        for s in shells:
            norms[s.ao_offset : s.ao_offset + ncart(s.l)] = component_norms(s.l)
        self.ao_norms = norms

        # nuclear data as arrays
        self.charges = np.array([a.ordinal for a in atoms], dtype=np.float64)
        self.positions = np.array([a.position for a in atoms], dtype=np.float64)

    # --- constructors -----------------------------------------------------

    @classmethod
    def load(cls, path: str | Path, basis: BasisSet, spherical: bool = False) -> "MolecularSystem":
        """Load a molecule JSON (reference format, positions in Bohr)."""
        with open(path) as f:
            data = json.load(f)
        atoms = [
            Atom(int(rec["element"]), np.asarray(rec["position"], dtype=np.float64))
            for rec in data
        ]
        return cls(atoms, basis, spherical=spherical)

    @classmethod
    def from_arrays(
        cls, ordinals: np.ndarray, positions: np.ndarray, basis: BasisSet,
        spherical: bool = False,
    ) -> "MolecularSystem":
        atoms = [
            Atom(int(z), np.asarray(p, dtype=np.float64))
            for z, p in zip(ordinals, positions)
        ]
        return cls(atoms, basis, spherical=spherical)

    # --- reference API parity --------------------------------------------

    def n_basis(self) -> int:
        """Number of (Cartesian) AO basis functions — molint's n_basis()."""
        return self._n_basis

    def n_basis_cart(self) -> int:
        return self._n_basis

    def n_electrons(self, charge: int = 0) -> int:
        return int(sum(a.ordinal for a in self.atoms)) - charge

    def nuclear_repulsion(self) -> float:
        """Classical point-charge repulsion (rhf.rs:110-122)."""
        z = self.charges
        r = self.positions
        diff = r[:, None, :] - r[None, :, :]
        dist = np.sqrt((diff**2).sum(-1))
        zz = z[:, None] * z[None, :]
        iu = np.triu_indices(len(z), k=1)
        return float((zz[iu] / dist[iu]).sum())

    def __repr__(self) -> str:
        return (
            f"MolecularSystem({len(self.atoms)} atoms, {len(self.shells)} shells, "
            f"{self._n_basis} AOs, basis={self.basis.name!r})"
        )
