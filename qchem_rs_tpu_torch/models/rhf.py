"""Restricted Hartree-Fock, in-core, as a plain loop on tensors (port of the
in-core branch of ``qchem_rs_tpu/models/rhf.py::restricted_hartree_fock``
and of ``_rhf_scf``).

Algorithmic parity with the reference (qchem-rs core/src/hf/rhf.rs:32-181):
nuclear repulsion (rhf.rs:110-122), H = T + V (rhf.rs:48), Löwdin X
(rhf.rs:124-131), Hückel guess (rhf.rs:133-150), the operator
(ij|kl) - 1/2 (ik|jl) (rhf.rs:58-62) held as one (n^2, n^2) matrix so each
pass's G is one matvec (kernel 2, ``ops/fock_matvec.py``), DIIS(4,6)
(rhf.rs:65), the FDS-SDF error (rhf.rs:71), E = 1/2 Tr[D(2H + G)] with the
*updated* density but the *pre-update* G (rhf.rs:84-85), max_iterations+1
passes (rhf.rs:66) and the 0-based reported iteration.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.diis import Diis
from qchem_rs_tpu_torch.ops import fock_matvec, one_electron
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class RestrictedHartreeFockOutput:
    """Mirrors RestrictedHartreeFockOutput (rhf.rs:14-30), with extras."""

    orbital_energies: np.ndarray  # ascending
    electronic_energy: float
    nuclear_repulsion: float
    iterations: int
    converged: bool
    # extras beyond the reference output:
    density: np.ndarray
    coefficients: np.ndarray
    timings: dict

    def total_energy(self) -> float:
        return self.electronic_energy + self.nuclear_repulsion


@dataclasses.dataclass
class _ScfResult:
    passes: int
    density: torch.Tensor
    energy: float
    converged: bool
    orbital_energies: torch.Tensor
    coefficients: torch.Tensor


def _sync(device: torch.device) -> None:
    """Wait for the device, so that host clocks time the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rhf_scf(H, X, S, nocc: int, config: HartreeFockConfig, terms: torch.Tensor) -> _ScfResult:
    """The SCF fixed-point iteration from the Hückel guess."""
    n = H.shape[0]
    diis_min, diis_max = config.diis_window(4, 6)
    diis = Diis(diis_max, diis_min, n, H.device)
    metric = config.convergence_metric
    D = scf.huckel_guess(H, S, X, nocc, scale=2.0)
    energy, rms, converged, passes = 0.0, math.inf, False, 0
    w = torch.zeros(n, dtype=H.dtype, device=H.device)
    C = torch.zeros((n, n), dtype=H.dtype, device=H.device)
    # reference loops 0..=max_iterations (rhf.rs:66): max_iterations+1 passes
    while not converged and passes <= config.max_iterations:
        G = fock_matvec.matvec(terms, D.reshape(-1)).reshape(n, n)  # rhf.rs:152-167
        F = H + G
        err = F @ D @ S - S @ D @ F  # rhf.rs:71
        F = diis.apply(err, F)
        C, w = scf.solve_fock(F, X)
        D_new = scf.density_from_coeffs(C, nocc, scale=2.0)
        d_change = D_new - D
        D = D + config.mixing_factor * d_change  # rhf.rs:78-82
        new_energy = float(0.5 * torch.sum(D * (2.0 * H + G)))  # rhf.rs:84-85
        new_rms = scf.convergence_value(
            metric, energy=new_energy, prev_energy=energy, err=err, d_change=d_change
        )
        converged = scf.converged_flag(metric, new_rms, rms, config.epsilon)
        if config.verbose:
            print(f"iteration {passes:<4} - electronic energy {new_energy:1.4f}. "
                  f"density rms {new_rms:1.4e}")
        energy, rms = new_energy, new_rms
        passes += 1
    return _ScfResult(passes, D, energy, converged, w, C)


def restricted_hartree_fock(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    device,
) -> RestrictedHartreeFockOutput:
    """Run in-core RHF on ``device`` (reference entry point rhf.rs:32-35).

    On a CUDA device the ERI tiles go through kernel 1 and every SCF pass's
    matvec through kernel 2; on the CPU both take their plain twins.
    """
    config = config or HartreeFockConfig()
    if config.fock_mode != "incore":
        raise NotImplementedError(f"fock_mode={config.fock_mode!r} is not ported; use 'incore'")
    if config.initial_guess != "huckel":
        raise NotImplementedError(f"initial_guess={config.initial_guess!r} is not ported")
    if any(config.electric_field):
        raise NotImplementedError("external electric fields are not ported")
    if config.level_shift != 0.0:
        raise NotImplementedError("level shifting is not ported")
    n_electrons = system.n_electrons(config.charge)
    if config.spin_multiplicity not in (0, 1):
        raise ValueError("RHF requires a closed shell (spin multiplicity 1)")
    if n_electrons % 2 != 0 and config.spin_multiplicity == 1:
        raise ValueError(f"RHF needs an even electron count, got {n_electrons}")
    nocc = n_electrons // 2
    device = torch.device(device)

    timings: dict = {}
    t0 = time.perf_counter()
    engine = TiledEriEngine(system, config.screening_threshold, device=device)
    t1 = time.perf_counter()
    S = one_electron.overlap(system, device)
    H = one_electron.kinetic(system, device) + one_electron.nuclear(system, device)
    X = scf.lowdin_x(S)
    _sync(device)
    timings["one_electron_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    terms = engine.finish_terms(engine.build())
    _sync(device)
    timings["eri_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    st = _rhf_scf(H, X, S, nocc, config, terms)
    _sync(device)
    timings["scf_s"] = time.perf_counter() - t1
    timings["total_s"] = time.perf_counter() - t0
    return RestrictedHartreeFockOutput(
        orbital_energies=st.orbital_energies.cpu().numpy(),
        electronic_energy=st.energy,
        nuclear_repulsion=system.nuclear_repulsion(),
        iterations=st.passes - 1,  # reference reports the 0-based pass index
        converged=st.converged,
        density=st.density.cpu().numpy(),
        coefficients=st.coefficients.cpu().numpy(),
        timings=timings,
    )
