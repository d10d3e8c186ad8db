"""Superposition of Atomic Densities (SAD) initial guess (port of
``qchem_rs_tpu/models/sad.py``).

The SCF starts from a block-diagonal assembly of spherically averaged
atomic Hartree-Fock densities instead of the extended-Hückel guess of the
reference (rhf.rs:133-150). Each element's atom is a fractional-occupation
restricted SCF: electrons fill orbitals in energy order and degenerate
groups (the p and d shells of the spherical atom) share them equally.

An atom is tiny, so its integrals come from the port's own one-electron
integrals and ``TiledEriEngine.finish_eri`` on the CPU, named explicitly,
and its SCF runs in numpy, as the JAX package solves its atoms on its CPU
backend. The molecular SCF stays on the caller's device. Densities are
geometry-free and are kept in a disk cache: ``QCHEM_TORCH_SAD_CACHE``, or
``qchem_rs_tpu_torch/_cache/sad`` beside the package. A spherical
system's atoms are solved in the spherical basis: the atom's Cartesian S,
H and ERIs are projected with its own transform
(``qchem_rs_tpu/models/sad.py:102-145``), and the cache keys carry the AO
convention, so that Cartesian and spherical atoms never share a file.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils.system import Atom, MolecularSystem

CACHE_ENV = "QCHEM_TORCH_SAD_CACHE"
_DEFAULT_CACHE = Path(__file__).resolve().parent.parent / "_cache" / "sad"


def _disk_dir() -> Path:
    return Path(os.environ.get(CACHE_ENV, _DEFAULT_CACHE))


def _fractional_occupations(w: np.ndarray, n_electrons: int,
                            degeneracy_tol: float = 1e-6) -> np.ndarray:
    """Aufbau filling with equal sharing inside degenerate groups (orbital
    energies closer than ``degeneracy_tol`` in the ascending ladder): per-
    orbital occupations in [0, 2] summing to ``n_electrons``."""
    n = len(w)
    occ = np.zeros(n)
    remaining = float(n_electrons)
    i = 0
    while i < n and remaining > 0:
        j = i + 1
        while j < n and abs(w[j] - w[j - 1]) < degeneracy_tol:
            j += 1
        g = j - i  # group size; capacity 2g electrons
        take = min(remaining, 2.0 * g)
        occ[i:j] = take / g
        remaining -= take
        i = j
    return occ


def _scf_from_integrals(S, H, V, Z: int) -> np.ndarray:
    """Fractional-occupation SCF in numpy from dense atomic integrals."""
    sw, U = np.linalg.eigh(S)
    X = (U / np.sqrt(sw)[None, :]) @ U.T
    n = S.shape[0]
    D = np.zeros((n, n))
    mix = 0.5  # fixed damping: fractional occupations can ring without it
    for _ in range(60):
        J = np.einsum("ijkl,kl->ij", V, D)
        K = np.einsum("ikjl,kl->ij", V, D)
        F = H + J - 0.5 * K
        w, Cp = np.linalg.eigh(X.T @ F @ X)
        C = X @ Cp
        occ = _fractional_occupations(w, Z)
        D_new = (C * occ[None, :]) @ C.T
        delta = np.max(np.abs(D_new - D))
        D = D + mix * (D_new - D)
        if delta < 1e-7:
            break
    return D


def compute_atomic_density(basis, Z: int, spherical: bool = False) -> np.ndarray:
    """Density of the neutral atom ``Z`` in ``basis``, solved on the CPU, in
    the spherical basis when ``spherical``."""
    system = MolecularSystem([Atom(Z, np.zeros(3))], basis)
    S = one_electron.overlap(system, "cpu").numpy()
    H = (one_electron.kinetic(system, "cpu") + one_electron.nuclear(system, "cpu")).numpy()
    engine = TiledEriEngine(system, 0.0, device="cpu")
    V = engine.finish_eri(engine.build()).numpy()
    if spherical:
        T = MolecularSystem([Atom(Z, np.zeros(3))], basis, spherical=True).sph_T
        S, H = T.T @ S @ T, T.T @ H @ T
        V = np.einsum("pqrs,pi,qj,rk,sl->ijkl", V, T, T, T, T, optimize=True)
    return _scf_from_integrals(S, H, V, Z)


def _element_fingerprint(basis, Z: int, spherical: bool = False) -> str:
    """Content hash of element Z's shells (l, exponents, coefficients) and
    the AO convention, so that densities are shared by basis files with the
    same element data and never between Cartesian and spherical atoms."""
    h = hashlib.sha256()
    h.update(f"sad-torch-v1|{Z}".encode())
    if spherical:
        h.update(b"|spherical")
    for spec in basis.shells_for(Z):
        h.update(str(spec.l).encode())
        h.update(np.asarray(spec.exponents, np.float64).tobytes())
        h.update(np.asarray(spec.coefficients, np.float64).tobytes())
    return h.hexdigest()[:24]


def _atomic_densities(basis, zs: list[int], spherical: bool = False) -> dict[int, np.ndarray]:
    """Densities of the elements ``zs``: from the disk cache, else solved
    and written there (through a temporary file and a rename)."""
    out: dict[int, np.ndarray] = {}
    cache = _disk_dir()
    for Z in zs:
        path = cache / f"{_element_fingerprint(basis, Z, spherical)}.npy"
        try:
            out[Z] = np.load(path)
            continue
        except (OSError, ValueError):
            pass
        out[Z] = compute_atomic_density(basis, Z, spherical)
        cache.mkdir(parents=True, exist_ok=True)
        tmp = cache / f".{path.stem}.{os.getpid()}.tmp.npy"  # np.save keeps a .npy name
        np.save(tmp, out[Z])
        os.replace(tmp, path)
    return out


def _atom_spans(system) -> list[tuple[int, int, int]]:
    """Per-atom (ordinal, ao_offset, nao) spans in the working basis (2l+1
    AOs a shell when spherical). Shells are built atom by atom
    (``utils/system.py``), so each atom owns one AO block."""
    per_atom = np.bincount(system.ao_atom_indices(), minlength=len(system.atoms))
    spans, off = [], 0
    for atom, nao in zip(system.atoms, per_atom):
        spans.append((atom.ordinal, off, int(nao)))
        off += int(nao)
    return spans


def sad_guess(system, charge: int = 0) -> np.ndarray:
    """Block-diagonal SAD density (nao, nao) for ``system``, scaled so that
    Tr[D S] is the electron count (neutral-atom sum minus ``charge``)."""
    spans = _atom_spans(system)
    atoms = _atomic_densities(system.basis, sorted({Z for Z, _, _ in spans}), system.spherical)
    n = system.n_basis()
    D = np.zeros((n, n))
    for Z, off, nao in spans:
        if atoms[Z].shape[0] != nao:
            raise RuntimeError(f"SAD atom block of Z={Z} has {atoms[Z].shape[0]} AOs, not {nao}")
        D[off : off + nao, off : off + nao] = atoms[Z]
    n_target = system.n_electrons(charge)
    if charge != 0 and n_target > 0:
        n_sad = float(np.sum(D * one_electron.overlap(system, "cpu").numpy()))
        if n_sad > 0:
            D *= n_target / n_sad
    return D
