"""Ideal-gas RRHO thermochemistry on harmonic frequencies (copy of
``qchem_rs_tpu/models/thermo.py``).

Rigid-rotor / harmonic-oscillator partition functions: translational
(Sackur-Tetrode), rotational (classical; linear, nonlinear or an atom, from
the principal moments of inertia), vibrational (quantum HO over the real
modes) and electronic (spin degeneracy only). numpy on the host: the
device work happened upstream, in the Hessian (``models/hessian.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from qchem_rs_tpu_torch.models.hessian import ATOMIC_MASS
from qchem_rs_tpu_torch.utils.system import MolecularSystem

# CODATA 2018
KB = 1.380649e-23  # J/K
H_PLANCK = 6.62607015e-34  # J s
NA = 6.02214076e23  # 1/mol
C_LIGHT = 2.99792458e10  # cm/s
AMU_KG = 1.66053906660e-27
BOHR_M = 0.529177210903e-10
HARTREE_J = 4.3597447222071e-18
R_GAS = KB * NA  # J/(mol K)


@dataclasses.dataclass
class ThermoOutput:
    temperature: float  # K
    pressure: float  # Pa
    zpe: float  # Hartree
    thermal_energy: float  # U - E_elec, Hartree (incl. ZPE)
    thermal_enthalpy: float  # H - E_elec, Hartree
    thermal_gibbs: float  # G - E_elec, Hartree
    entropy: float  # J/(mol K), total
    entropy_parts: dict  # trans/rot/vib/elec, J/(mol K)
    rotational_temperatures: np.ndarray  # K (empty for an atom)
    linear: bool
    n_vibrations: int


def _principal_moments(system: MolecularSystem) -> np.ndarray:
    """Principal moments of inertia (kg m^2), ascending."""
    masses = np.array([ATOMIC_MASS[a.ordinal] for a in system.atoms]) * AMU_KG
    pos = np.asarray(system.positions) * BOHR_M
    com = (masses[:, None] * pos).sum(0) / masses.sum()
    r = pos - com
    eye = np.eye(3)
    inertia = sum(
        m * ((ri @ ri) * eye - np.outer(ri, ri)) for m, ri in zip(masses, r)
    )
    return np.linalg.eigvalsh(inertia)


def thermochemistry(
    system: MolecularSystem,
    frequencies_cm1: Sequence[float],
    *,
    temperature: float = 298.15,
    pressure: float = 101325.0,
    symmetry_number: int = 1,
    spin_multiplicity: int = 1,
    zero_tol: float = 50.0,
) -> ThermoOutput:
    """RRHO thermal corrections from harmonic frequencies (cm^-1).

    ``frequencies_cm1`` may be the full 3N list from harmonic_frequencies —
    modes with |freq| < zero_tol (translations/rotations) are dropped, and
    imaginary modes (negative entries) are excluded from the partition
    function with no error (standard practice; the caller should know it
    is not at a minimum)."""
    T, P = float(temperature), float(pressure)
    if T <= 0:
        raise ValueError("temperature must be positive")
    freqs = np.asarray([f for f in np.asarray(frequencies_cm1) if f >= zero_tol])
    natoms = len(system.atoms)

    masses = np.array([ATOMIC_MASS[a.ordinal] for a in system.atoms]) * AMU_KG
    M = masses.sum()

    # --- translation ---------------------------------------------------------
    q_trans = (2.0 * np.pi * M * KB * T / H_PLANCK**2) ** 1.5 * (KB * T / P)
    s_trans = R_GAS * (np.log(q_trans) + 1.0 + 1.5)  # Sackur-Tetrode
    e_trans = 1.5 * R_GAS * T  # J/mol

    # --- rotation ------------------------------------------------------------
    if natoms == 1:
        s_rot, e_rot = 0.0, 0.0
        theta = np.array([])
        linear = False
    else:
        I = _principal_moments(system)
        hbar = H_PLANCK / (2.0 * np.pi)
        linear = I[0] < 1e-3 * I[2]
        if linear:
            theta = np.array([hbar**2 / (2.0 * I[2] * KB)])
            q_rot = T / (symmetry_number * theta[0])
            s_rot = R_GAS * (np.log(q_rot) + 1.0)
            e_rot = R_GAS * T
        else:
            theta = hbar**2 / (2.0 * I * KB)
            q_rot = (
                np.sqrt(np.pi) / symmetry_number * T**1.5 / np.sqrt(theta.prod())
            )
            s_rot = R_GAS * (np.log(q_rot) + 1.5)
            e_rot = 1.5 * R_GAS * T

    # --- vibration (quantum HO, bottom-of-well reference) --------------------
    theta_vib = H_PLANCK * C_LIGHT * freqs / KB  # K
    x = theta_vib / T
    zpe_j = 0.5 * R_GAS * theta_vib.sum()  # J/mol
    with np.errstate(over="ignore"):
        expm = np.expm1(x)
    e_vib = zpe_j + R_GAS * (theta_vib / expm).sum()
    s_vib = R_GAS * float((x / expm - np.log1p(-np.exp(-x))).sum()) if len(x) else 0.0

    # --- electronic ----------------------------------------------------------
    s_elec = R_GAS * np.log(max(int(spin_multiplicity), 1))

    u = e_trans + e_rot + e_vib  # J/mol above the electronic minimum
    h = u + R_GAS * T
    s_total = s_trans + s_rot + s_vib + s_elec
    g = h - T * s_total

    to_hartree = 1.0 / (HARTREE_J * NA)
    return ThermoOutput(
        temperature=T,
        pressure=P,
        zpe=zpe_j * to_hartree,
        thermal_energy=u * to_hartree,
        thermal_enthalpy=h * to_hartree,
        thermal_gibbs=g * to_hartree,
        entropy=float(s_total),
        entropy_parts={
            "trans": float(s_trans),
            "rot": float(s_rot),
            "vib": float(s_vib),
            "elec": float(s_elec),
        },
        rotational_temperatures=theta,
        linear=bool(linear),
        n_vibrations=len(freqs),
    )
