"""Geometry optimization on analytic gradients (port of
``qchem_rs_tpu/models/optimize.py``): RHF, or UHF for open shells, the
method chosen by shell parity (``gradients.is_open_shell``).

L-BFGS-B (scipy, on the host) over the nuclear coordinates, each energy
and gradient from a freshly converged SCF on ``device``, warm-started from
the previous geometry's density. Every step builds a fresh engine at its
geometry: nothing of one geometry's integral structure is carried to the
next.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class OptimizationResult:
    positions: np.ndarray  # (natom, 3), Bohr
    energy: float
    gradient_norm: float  # max |dE/dx| at the final geometry
    steps: int
    converged: bool
    energies: list  # per-step energy trace


def optimize_geometry(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    gtol: float = 3e-5,
    max_steps: int = 50,
    device="cuda",
) -> OptimizationResult:
    """Minimize the SCF energy over the nuclear positions (L-BFGS-B).

    ``gtol`` is the max-abs gradient threshold (Hartree/Bohr). The SCF must
    converge tightly (epsilon <= 1e-9 recommended): gradient noise stalls
    quasi-Newton updates."""
    from scipy.optimize import minimize

    from qchem_rs_tpu_torch.models.gradients import scf_and_gradient

    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=300)
    shape = np.asarray(system.positions).shape
    state = {"density": None, "energies": [], "steps": 0}

    def eg(x):
        sys_x = system.with_positions(x.reshape(shape))
        try:
            out, g = scf_and_gradient(sys_x, config, density_guess=state["density"],
                                      device=device)
        except RuntimeError as e:
            raise RuntimeError(f"{e} during optimization") from e
        state["density"] = out.density
        state["energies"].append(out.total_energy())
        state["steps"] += 1
        return out.total_energy(), g.reshape(-1)

    res = minimize(
        eg,
        np.asarray(system.positions, dtype=np.float64).reshape(-1),
        jac=True,
        method="L-BFGS-B",
        options={"maxiter": max_steps, "gtol": gtol, "ftol": 1e-12},
    )
    g = np.abs(res.jac).max()
    return OptimizationResult(
        positions=res.x.reshape(shape),
        energy=float(res.fun),
        gradient_norm=float(g),
        steps=state["steps"],
        converged=bool(g < 10 * gtol),
        energies=state["energies"],
    )
