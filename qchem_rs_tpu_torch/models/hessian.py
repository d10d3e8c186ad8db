"""Harmonic vibrational analysis on a semi-numerical Hessian (port of
``qchem_rs_tpu/models/hessian.py``).

The Hessian is the central difference of the analytic nuclear gradient
(``models/gradients.py``), one SCF and gradient per displaced geometry,
each warm-started from the previous density. Frequencies come from the
mass-weighted Hessian's eigenvalues; translations and rotations show up
as near-zero modes (reported, not projected out: their smallness checks
the gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: most-abundant-isotope masses (amu) by Z, Z = 1..18 (every element the
#: bundled basis sets reach that has a mass here)
ATOMIC_MASS = {
    1: 1.00782503,
    2: 4.00260325,
    3: 7.01600455,
    4: 9.01218220,
    5: 11.00930540,
    6: 12.0,
    7: 14.00307401,
    8: 15.99491462,
    9: 18.99840316,
    10: 19.99244018,
    11: 22.98976928,
    12: 23.98504170,
    13: 26.98153863,
    14: 27.97692653,
    15: 30.97376163,
    16: 31.97207117,
    17: 34.96885268,
    18: 39.96238312,
}

#: 1 amu in electron masses
AMU_TO_ME = 1822.888486209
#: Hartree/(Bohr^2 m_e) angular frequency to wavenumbers (cm^-1)
AU_TO_CM1 = 219474.6313632


@dataclasses.dataclass
class HarmonicResult:
    frequencies_cm1: np.ndarray  # all 3N modes, ascending (imaginary < 0)
    hessian: np.ndarray  # (3N, 3N), Hartree/Bohr^2
    n_zero_modes: int  # modes with |freq| < zero_tol


def hessian_fd(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    step: float = 5e-3,
    device="cuda",
) -> np.ndarray:
    """(3N, 3N) Cartesian Hessian by central differences of the analytic
    gradient (RHF, or UHF for open shells), symmetrized; ``step`` in
    Bohr."""
    from qchem_rs_tpu_torch.models.gradients import scf_and_gradient

    config = config or HartreeFockConfig(epsilon=1e-11, max_iterations=300)
    x0 = np.asarray(system.positions, dtype=np.float64)
    n3 = x0.size
    H = np.zeros((n3, n3))
    guess = None
    for k in range(n3):
        cols = []
        for sgn in (+1.0, -1.0):
            x = x0.copy().reshape(-1)
            x[k] += sgn * step
            sys_x = system.with_positions(x.reshape(x0.shape))
            try:
                out, g = scf_and_gradient(sys_x, config, density_guess=guess, device=device)
            except RuntimeError as e:
                raise RuntimeError(f"{e} during Hessian build") from e
            guess = out.density
            cols.append(g.reshape(-1))
        H[:, k] = (cols[0] - cols[1]) / (2.0 * step)
    return 0.5 * (H + H.T)


def harmonic_frequencies(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    step: float = 5e-3,
    zero_tol: float = 50.0,
    device="cuda",
) -> HarmonicResult:
    """Harmonic frequencies (cm^-1) at the system's geometry (optimize
    first: away from a stationary point translations mix into the
    vibrations)."""
    unknown = sorted({a.ordinal for a in system.atoms} - ATOMIC_MASS.keys())
    if unknown:
        # fail before the 6N SCF and gradient runs of the Hessian, not after
        raise ValueError(
            f"no atomic mass tabulated for Z={unknown}; extend "
            "qchem_rs_tpu_torch.models.hessian.ATOMIC_MASS"
        )
    H = hessian_fd(system, config, step=step, device=device)
    masses = np.array([ATOMIC_MASS[a.ordinal] * AMU_TO_ME for a in system.atoms])
    minv = 1.0 / np.sqrt(np.repeat(masses, 3))
    w = np.linalg.eigvalsh(H * minv[:, None] * minv[None, :])
    freqs = np.sign(w) * np.sqrt(np.abs(w)) * AU_TO_CM1
    return HarmonicResult(
        frequencies_cm1=freqs,
        hessian=H,
        n_zero_modes=int((np.abs(freqs) < zero_tol).sum()),
    )
